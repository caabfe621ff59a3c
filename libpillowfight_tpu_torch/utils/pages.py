"""Synthetic scan-like pages, made from a seed with numpy.

`synthetic_pages` is the page the JAX package's `bench.py` times
(`bench._pages`), copied so that the port needs nothing of that file: a
black border, 3-px text lines, a gray block and 500 speckles. A test
holds the two byte-identical. `text_pages` adds letter-sized glyphs
(I, L and T shapes of 5-px strokes) between every other pair of text
lines, and closes the black border into a frame, so that SWT finds
letters on it: canny's thresholds are fractions of the page's strongest
gradient, and on a page that is light up to its rim that is the rim
itself (the blur and the gradient pad with zeros), twice as strong as
any glyph's edge. `bar_pages` repeats the letters of the reference's
SWT oracle test over a page. `snake_pages` is a page whose
blackfilter flood winds across every row shard boundary. `flood_cases`,
`label_cases`, `blur_cases`, `line_count_cases`, `pack_cases`,
`unpack_cases` and `cert_cases` (also
the ball count's) are the planes on which the kernels are held to their
plain versions on the card: the CPU tests hold the plain versions to the
reference on the same planes.
"""

from __future__ import annotations

import numpy as np

from ..ops.conv import gaussian_taps


def synthetic_pages(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """uint8 RGBA [b,h,w,4]: a scan-like page; every page of the batch
    is the same (the speckles are shared)."""
    rng = np.random.default_rng(seed)
    pages = np.full((b, h, w, 4), 245, np.uint8)
    pages[..., 3] = 255
    pages[:, :, : w // 40, :3] = 0
    for y in range(h // 10, h - h // 10, 40):
        pages[:, y: y + 3, w // 8: w - w // 8, :3] = 15
    pages[:, h // 2: h // 2 + h // 8, w // 10: w // 4, :3] = 190
    ys = rng.integers(0, h, 500)
    xs = rng.integers(w // 20, w, 500)
    pages[:, ys, xs, :3] = 30
    return pages


GLYPH_H, GLYPH_STROKE, GLYPH_PITCH = 24, 5, 40


def text_pages(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """`synthetic_pages` plus rows of glyphs: 24-px-high I, L and T shapes
    of 5-px strokes, one every 40 px, in every other gap between the text
    lines (about 1,600 letters on an A4 300 dpi page), inside a black
    frame as wide as the left border."""
    pages = synthetic_pages(b, h, w, seed)
    frame = w // 40
    pages[:, :frame, :, :3] = 0
    pages[:, h - frame:, :, :3] = 0
    pages[:, :, w - frame:, :3] = 0
    s, gh = GLYPH_STROKE, GLYPH_H
    for row, y in enumerate(range(h // 10, h - h // 10 - 40, 80)):
        top = y + 10
        for i, x in enumerate(range(w // 8 + 10, w - w // 8 - 20,
                                    GLYPH_PITCH)):
            kind = (i + row) % 3
            stem = x + (6 if kind == 2 else 0)
            pages[:, top: top + gh, stem: stem + s, :3] = 15
            if kind == 1:    # L: a foot to the right
                pages[:, top + gh - s: top + gh, x: x + 16, :3] = 15
            elif kind == 2:  # T: a bar across the top
                pages[:, top: top + s, x: x + 17, :3] = 15
    return pages


BAR_W, BAR_H, BAR_PITCH, BAR_ROW_PITCH = 6, 50, 20, 80


def bar_pages(b: int, h: int, w: int) -> np.ndarray:
    """uint8 RGBA [b,h,w,4]: the letters of the reference's SWT oracle
    test (`tests/test_golden_oracle.py` `_text_page`: black bars 6 px
    wide and 50 px tall on white, and light gray shading that the letter
    filters must ignore) repeated over the page, one bar every 20 px in
    rows 80 px apart."""
    g = np.full((h, w), 255, np.uint8)
    for y in range(25, h - BAR_H - 10, BAR_ROW_PITCH):
        for x in range(20, w - 30, BAR_PITCH):
            g[y: y + BAR_H, x: x + BAR_W] = 0
    for y in range(80, h - 20, 400):
        g[y: y + 12, 8: 40] = 210
    page = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
    return np.broadcast_to(page, (b, h, w, 4)).copy()


SNAKE_PITCH, SNAKE_DARK = 50, 15


def snake_pages(b: int, h: int, w: int, arms: int = 6) -> np.ndarray:
    """uint8 RGBA [b,h,w,4]: a 3-px dark snake on a light page, `arms`
    vertical arms 50 px apart from row 6 to h - 6 joined at alternating
    ends, and a solid 28-px square at its start that seeds the
    blackfilter's flood. With the page's rows sharded, that flood crosses
    every shard boundary once an arm (`parallel/spatial.py`)."""
    pages = np.full((b, h, w, 4), 245, np.uint8)
    pages[..., 3] = 255
    xs = [30 + SNAKE_PITCH * i for i in range(arms)]
    for i, x in enumerate(xs):
        pages[:, 6:h - 6, x:x + 3, :3] = SNAKE_DARK
        if i + 1 < arms:
            y = h - 9 if i % 2 == 0 else 6
            pages[:, y:y + 3, x:xs[i + 1] + 3, :3] = SNAKE_DARK
    pages[:, 6:34, 20:48, :3] = SNAKE_DARK
    return pages


def lit_snake_pages(b: int, h: int, w: int, arms: int = 6,
                    faint: int | None = None) -> np.ndarray:
    """uint8 RGBA [b,h,w,4]: the 3-px snake of `snake_pages`, bright
    (240) on black, without the square. On black the page's edge has no
    gradient, so canny's edges are the snake's and SWT's strokes are its
    arms: one component that crosses every row-shard boundary. With
    `faint`, every part of the snake but its first 34 rows has that gray:
    canny's strong pixels lie at its start and its hysteresis follows the
    faint arms from shard to shard."""
    pages = np.zeros((b, h, w, 4), np.uint8)
    pages[..., 3] = 255
    xs = [30 + SNAKE_PITCH * i for i in range(arms)]
    v = 240 if faint is None else faint
    for i, x in enumerate(xs):
        pages[:, 6:h - 6, x:x + 3, :3] = v
        if i + 1 < arms:
            y = h - 9 if i % 2 == 0 else 6
            pages[:, y:y + 3, x:xs[i + 1] + 3, :3] = v
    pages[:, 6:40, xs[0]:xs[0] + 3, :3] = 240
    return pages


def _snake(h: int, w: int, x0: int, arms: int, vertical: bool):
    """A one-pixel path of `arms` parallel arms two pixels apart, joined at
    alternating ends, from column (or row) x0 on; the seed is its start."""
    mask = np.zeros((1, h, w), bool)
    for i in range(arms):
        mask[0, :, x0 + 2 * i] = True
        if i + 1 < arms:
            mask[0, h - 1 if i % 2 == 0 else 0, x0 + 2 * i + 1] = True
    seeds = np.zeros_like(mask)
    seeds[0, 0, x0] = True
    if not vertical:
        mask, seeds = mask.transpose(0, 2, 1), seeds.transpose(0, 2, 1)
    return np.ascontiguousarray(seeds), np.ascontiguousarray(mask)


def _gaps(leap: int):
    """Pixels exactly `leap` and `leap + 1` apart along each axis and on
    the diagonal: the first are joined, the second are not. Page 1 is
    page 0 turned by 180 degrees."""
    n = 2 * leap + 10
    mask = np.zeros((2, n, n + 2), bool)
    seeds = np.zeros_like(mask)
    a = 5
    for y, x in ((a, a), (a, a + leap), (a + leap, a), (a + leap, a + leap),
                 (a, a + 2 * leap + 1), (a + 2 * leap + 1, a)):
        mask[0, y, x] = True
    seeds[0, a, a] = True
    mask[1], seeds[1] = mask[0, ::-1, ::-1], seeds[0, ::-1, ::-1]
    return seeds, mask


# (name, rows, columns, leap) of the random planes of `flood_cases`: rows
# around a 32-row band, columns around a 128-thread strip and around 217
FLOOD_RANDOM = (("h31_w127_leap1", 31, 127, 1), ("h33_w218_leap1", 33, 218, 1),
                ("h32_w128_leap20", 32, 128, 20),
                ("h64_w130_leap20", 64, 130, 20),
                ("h33_w129_leap31", 33, 129, 31),
                ("h65_w217_leap32", 65, 217, 32),
                ("h65_w216_leap33", 65, 216, 33))
FLOOD_GAP_LEAPS = (1, 20, 31, 32, 33)
FLOOD_CASE_NAMES = (tuple(f"random_{c[0]}" for c in FLOOD_RANDOM)
                    + tuple(f"gaps_leap{k}" for k in FLOOD_GAP_LEAPS)
                    + ("snake_rows", "snake_columns", "border_ring",
                       "no_seeds"))


def flood_cases(seed: int = 0) -> list:
    """Edge cases of the exact flood, as (name, seeds, mask, leap) with
    bool [B,H,W] planes, in the order of `FLOOD_CASE_NAMES`: random planes
    near the percolation density of their leap, gaps of exactly `leap`
    and `leap + 1`, one-pixel snakes along each axis (the one along the
    columns needs a sweep down or up for every arm), a solid ring with a
    blob out of reach inside, and a plane without seeds. Every page is at
    most 100 x 220 pixels."""
    rng = np.random.default_rng(seed)
    cases = []
    for name, h, w, leap in FLOOD_RANDOM:
        density = 0.45 if leap == 1 else 3.0 / (2 * leap + 1) ** 2
        mask = rng.random((2, h, w)) < density
        seeds = mask & (rng.random((2, h, w)) < 0.02)
        seeds[:, h // 2, w // 3] = mask[:, h // 2, w // 3] = True
        cases.append((f"random_{name}", seeds, mask, leap))
    for leap in FLOOD_GAP_LEAPS:
        cases.append((f"gaps_leap{leap}", *_gaps(leap), leap))
    cases.append(("snake_rows", *_snake(130, 33, 3, 9, False), 1))
    cases.append(("snake_columns", *_snake(65, 217, 119, 7, True), 1))
    mask = np.zeros((1, 65, 217), bool)
    mask[0, :3] = mask[0, -3:] = mask[0, :, :3] = mask[0, :, -3:] = True
    mask[0, 31:34, 100:110] = True  # 28 rows from the ring: out of reach
    seeds = np.zeros_like(mask)
    seeds[0, 64, 216] = True
    cases.append(("border_ring", seeds, mask, 20))
    mask = rng.random((1, 40, 150)) < 0.4
    cases.append(("no_seeds", np.zeros_like(mask), mask, 1))
    assert tuple(c[0] for c in cases) == FLOOD_CASE_NAMES
    return cases


LABEL_OFFSETS = ((0, 1), (1, 0), (1, 1), (1, -1))  # as `ops.cuda.label.OFFSETS`
LABEL_TILE_H, LABEL_TILE_W = 32, 64  # the label kernel's tile


def _links8(valid: np.ndarray) -> dict:
    """Every pair of valid 8-neighbours linked."""
    links = {}
    for dy, dx in LABEL_OFFSETS:
        other = np.zeros_like(valid)
        h, w = valid.shape[1:]
        other[:, :h - dy, max(0, -dx):w - max(0, dx)] = \
            valid[:, dy:, max(0, dx):w + min(0, dx)]
        links[(dy, dx)] = valid & other
    return links


def _spiral(h: int, w: int) -> np.ndarray:
    """A one-pixel rectangular spiral on an h x w plane, arms two pixels
    apart, from the top left corner inwards: one 8-connected component."""
    plane = np.zeros((h, w), bool)
    top, bottom, left, right, start = 0, h - 1, 0, w - 1, 0
    while top <= bottom and start <= right:
        plane[top, start:right + 1] = True
        plane[top:bottom + 1, right] = True
        plane[bottom, left:right + 1] = True
        plane[top + 2:bottom + 1, left] = True
        start = left
        top, bottom, left, right = top + 2, bottom - 2, left + 2, right - 2
    return plane


# (rows, columns) of the random planes of `label_cases`: one under, at and
# one over the kernel's tile, and around a 4-byte and a 16-byte load
LABEL_RANDOM = ((31, 63), (32, 64), (33, 65), (64, 128), (65, 129), (7, 3),
                (5, 4), (9, 5), (33, 15), (34, 16), (35, 17))
LABEL_CASE_NAMES = (tuple(f"random_h{h}_w{w}" for h, w in LABEL_RANDOM)
                    + ("random_8conn_b3", "snake_rows", "snake_columns",
                       "spiral", "least_index_last", "diagonals_only",
                       "links_off_page_or_invalid", "empty", "full_8conn",
                       "full_links", "solid_blocks_b3"))


def label_cases(seed: int = 0) -> list:
    """Edge cases of the component labels, as (name, valid, links) with
    valid bool [B,H,W] and links {(dy,dx): bool [B,H,W]} over
    `LABEL_OFFSETS` or None (8-connectivity), in the order of
    `LABEL_CASE_NAMES`: random planes with random links at heights and
    widths around the kernel's tile and its 4- and 16-byte loads; snakes
    and a spiral that cross tile borders many times; a component whose
    least index lies in the last tile it touches; links along the
    diagonals only, across tile corners; links that leave the page or meet
    an invalid pixel (they join nothing); an empty and a full plane; solid
    blocks over several tiles. One to three pages, each at most 200
    pixels a side."""
    rng = np.random.default_rng(seed)
    th, tw = LABEL_TILE_H, LABEL_TILE_W
    cases = []
    for h, w in LABEL_RANDOM:
        valid = rng.random((2, h, w)) < 0.55
        links = {d: v & (rng.random(valid.shape) < 0.6)
                 for d, v in _links8(valid).items()}
        cases.append((f"random_h{h}_w{w}", valid, links))
    cases.append(("random_8conn_b3", rng.random((3, 66, 130)) < 0.45, None))

    _, rows = _snake(2 * th + 3, 3 * tw + 5, 3, 2 * th - 1, False)
    cases.append(("snake_rows", rows, None))
    _, columns = _snake(2 * th + 5, 2 * tw + 9, tw - 9, 12, True)
    cases.append(("snake_columns", columns, _links8(columns)))
    cases.append(("spiral", _spiral(3 * th + 2, 2 * tw + 3)[None], None))

    # a hook: down the right, along the bottom, up the left to the first
    # row, so the component's least index lies in the tile reached last
    hook = np.zeros((1, 2 * th + 8, 2 * tw + 8), bool)
    hook[0, 5:, -3] = hook[0, -2, 2:-2] = hook[0, :, 2] = True
    cases.append(("least_index_last", hook, None))

    # stairs along both diagonals through the tile corners, linked along
    # the diagonals only (every pixel has valid row and column neighbours)
    diag = np.ones((1, 2 * th + 2, 2 * tw + 2), bool)
    none = np.zeros_like(diag)
    cases.append(("diagonals_only", diag,
                  {(0, 1): none, (1, 0): none,
                   (1, 1): diag.copy(), (1, -1): diag.copy()}))

    # every link bit set, also on invalid pixels and on the page's last
    # row and columns: page 0 a checkerboard, where only the diagonal
    # links join valid pixels, page 1 with an invalid row and two invalid
    # columns along the tile's edges
    valid = np.ones((2, th + 1, tw + 1), bool)
    valid[0, ::2, 1::2] = valid[0, 1::2, ::2] = False
    valid[1, :, tw - 1:tw + 1] = False
    valid[1, th - 1, :] = False
    every = np.ones_like(valid)
    cases.append(("links_off_page_or_invalid", valid,
                  {d: every.copy() for d in LABEL_OFFSETS}))

    empty = np.zeros((1, th + 1, tw + 4), bool)
    cases.append(("empty", empty, None))
    cases.append(("full_8conn", np.ones((1, 2 * th + 1, 2 * tw + 4), bool),
                  None))
    full = np.ones((1, 2 * th, 2 * tw), bool)
    cases.append(("full_links", full, _links8(full)))

    blocks = np.zeros((3, 3 * th + 1, 3 * tw), bool)
    blocks[0, 10:th + 20, 20:2 * tw + 30] = True
    blocks[1, :, tw - 2:tw + 2] = blocks[1, th - 1:th + 1, :] = True
    blocks[2, 2 * th:, :] = blocks[2, :, 2 * tw + 8:] = True
    blocks[2, th, tw] = True  # a pixel on its own
    cases.append(("solid_blocks_b3", blocks, None))
    assert tuple(c[0] for c in cases) == LABEL_CASE_NAMES
    return cases


def offset_view(t, offset: int):
    """A contiguous copy of tensor t that starts `offset` elements into
    its buffer: with an odd offset its data pointer is not 16-byte
    aligned, as a view such as `plane[1:]` of an odd-sized plane."""
    buf = t.new_empty(t.numel() + offset)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# (name, N, H, W, sigma, nb_stddev) of `blur_cases`: the 21 taps of every
# path (sigma 2, 5 stddev) at heights around a group of 21 rows and the
# generic tile's 32, widths around a 16-byte load, the 256-column strip
# and the generic tile's 128, planes smaller than the 10-px halo, N = 1
# and 3 x 2 (the RGB planes of 2 pages); 1, 3 and 97 taps (the generic
# instance), and 49 taps of which the outer ones are 0 in f32 and the
# others normal floats (XLA's CPU fold flushes a subnormal tap to 0)
BLUR_SHAPES = (("h1_w1", 1, 1, 1, 2.0, 5), ("h5_w7", 1, 5, 7, 2.0, 5),
               ("h21_w15", 2, 21, 15, 2.0, 5), ("h22_w16", 1, 22, 16, 2.0, 5),
               ("h20_w17", 1, 20, 17, 2.0, 5),
               ("h43_w255", 1, 43, 255, 2.0, 5),
               ("h42_w256", 1, 42, 256, 2.0, 5),
               ("h33_w257_n6", 6, 33, 257, 2.0, 5),
               ("h70_w258", 1, 70, 258, 2.0, 5),
               ("h250_w300", 2, 250, 300, 2.0, 5),
               ("h40_w60_1tap", 2, 40, 60, 2.0, 0),
               ("h31_w129_3taps", 1, 31, 129, 0.8, 1),
               ("h33_w127_97taps", 1, 33, 127, 8.0, 6),
               ("h64_w130_zero_taps", 1, 64, 130, 0.4, 60))
BLUR_CASE_NAMES = (tuple(c[0] for c in BLUR_SHAPES)
                   + ("inf_pixel", "inf_pixel_zero_taps", "unaligned_view"))


def blur_cases(seed: int = 0) -> list:
    """Edge cases of the separable blur, as (name, planes f32 [N,H,W] in
    [0, 255], taps, offset) in the order of `BLUR_CASE_NAMES`: the shapes
    and taps of `BLUR_SHAPES`, a plane with one +inf pixel under 21 taps
    and under taps with zeros (a tap of 0 must be skipped, not folded as
    0 x inf), and a view whose data pointer is not 16-byte aligned
    (`offset`: hand the planes to the kernel through `offset_view`)."""
    rng = np.random.default_rng(seed)
    cases = []
    for name, n, h, w, sigma, nb in BLUR_SHAPES:
        planes = (rng.random((n, h, w)) * 255).astype(np.float32)
        cases.append((name, planes, gaussian_taps(sigma, nb), 0))
    # the shape of h42_w256 again: a reference that compiles a shape once
    # (XLA op by op) takes these at little cost
    for name, sigma, nb in (("inf_pixel", 2.0, 5),
                            ("inf_pixel_zero_taps", 0.4, 60)):
        planes = (rng.random((1, 42, 256)) * 255).astype(np.float32)
        planes[0, 20, 40] = np.inf
        cases.append((name, planes, gaussian_taps(sigma, nb), 0))
    planes = (rng.random((1, 42, 256)) * 255).astype(np.float32)
    cases.append(("unaligned_view", planes, gaussian_taps(2.0, 5), 1))
    assert tuple(c[0] for c in cases) == BLUR_CASE_NAMES
    return cases


# (name, B, H, W) of the random planes of `line_count_cases`: heights
# around the kernel's 128-row band, widths around a 16-byte load and its
# 512-column chunk, B = 1 and 3 x 2
LINE_COUNT_SHAPES = (("h1_w1", 1, 1, 1), ("h127_w15", 2, 127, 15),
                     ("h128_w16", 1, 128, 16), ("h129_w17", 1, 129, 17),
                     ("h3_w511", 1, 3, 511), ("h40_w512", 1, 40, 512),
                     ("h130_w513_b6", 6, 130, 513))
LINE_COUNT_CASE_NAMES = (tuple(c[0] for c in LINE_COUNT_SHAPES)
                         + ("all_dark_h300_w48", "all_dark_h300_w37",
                            "empty", "uint8_values", "unaligned_view"))


def line_count_cases(seed: int = 0) -> list:
    """Edge cases of the line counts, as (name, plane [B,H,W] bool or
    uint8, offset) in the order of `LINE_COUNT_CASE_NAMES`: random bool
    planes of `LINE_COUNT_SHAPES`; all-dark planes of 300 rows (more
    than a byte counter holds) on the 16-byte and the byte path; an empty
    plane; a uint8 plane of values 0 to 255 (each non-zero byte counts
    1); a view whose data pointer is not 16-byte aligned (`offset`: hand
    the plane to the kernel through `offset_view`)."""
    rng = np.random.default_rng(seed)
    cases = []
    for name, b, h, w in LINE_COUNT_SHAPES:
        cases.append((name, rng.random((b, h, w)) < 0.4, 0))
    cases.append(("all_dark_h300_w48", np.ones((1, 300, 48), bool), 0))
    cases.append(("all_dark_h300_w37", np.ones((2, 300, 37), bool), 0))
    cases.append(("empty", np.zeros((1, 70, 600), bool), 0))
    values = rng.integers(0, 256, (2, 60, 80), dtype=np.uint8)
    values[:, ::3] = 0
    cases.append(("uint8_values", values, 0))
    cases.append(("unaligned_view", rng.random((2, 33, 64)) < 0.5, 1))
    assert tuple(c[0] for c in cases) == LINE_COUNT_CASE_NAMES
    return cases


# widths and heights of the random planes of `pack_cases`: 16-byte loads
# (16, 2480: A4 at 300 dpi), 4-byte loads (36), byte loads (1, 15, 17,
# 130), heights around a word row and A4's 3508 (109 word rows and 20
# rows); `reduced` brings 3508 down to 116 (the same 20 rows past a word)
PACK_WIDTHS = (1, 15, 16, 17, 36, 130, 2480)
PACK_HEIGHTS = (1, 31, 32, 33, 3508)
PACK_REDUCED_H = 116


def pack_cases(seed: int = 0, reduced: bool = False) -> list:
    """Edge cases of the pack, as (name, plane [B,H,W] bool or uint8,
    offset): random bool planes of every width and height above; an
    all-dark and an empty A4 plane; uint8 planes of values 0 to 255 on
    each load width (each non-zero byte sets one bit); views whose data
    pointer is 1 and 4 bytes past a 16-byte boundary (`offset`: hand the
    plane to the kernel through `offset_view`), which take byte and
    4-byte loads."""
    rng = np.random.default_rng(seed)
    tall = PACK_REDUCED_H if reduced else 3508
    cases = []
    for h in PACK_HEIGHTS:
        h = tall if h == 3508 else h
        for w in PACK_WIDTHS:
            b = 1 if h * w > 1_000_000 else 2
            cases.append((f"h{h}_w{w}", rng.random((b, h, w)) < 0.5, 0))
    cases.append((f"all_dark_h{tall}_w2480", np.ones((2, tall, 2480), bool),
                  0))
    cases.append((f"empty_h{tall}_w2480", np.zeros((2, tall, 2480), bool), 0))
    for h, w in ((70, 2480), (45, 36), (40, 17)):
        values = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
        values[:, ::3] = 0
        cases.append((f"uint8_values_h{h}_w{w}", values, 0))
    for offset in (1, 4):
        cases.append((f"unaligned_view_{offset}",
                      rng.random((2, 33, 2480)) < 0.5, offset))
    return cases



# word offsets of the unaligned word views of `unpack_cases`: 4 and 8
# bytes past a 16-byte boundary
UNPACK_WORD_OFFSETS = (1, 2)


def unpack_cases(seed: int = 0, reduced: bool = False) -> list:
    """Edge cases of the unpack, as (name, plane bool [B,H,W], offset): the
    aligned planes of `pack_cases` as their non-zero test (every store
    width: 16 bytes at W = 16 and 2480, 4 bytes at W = 36, bytes at W = 1,
    15, 17 and 130; heights around a word row up to A4's), to be packed
    and unpacked, and two A4-wide planes whose words go to the kernel
    through `offset_view` 1 and 2 words past a 16-byte boundary (`offset`,
    in words), which take 4-byte stores."""
    cases = [(name, plane != 0, 0)
             for name, plane, offset in pack_cases(seed, reduced) if not offset]
    rng = np.random.default_rng(seed + 1)
    for offset in UNPACK_WORD_OFFSETS:
        cases.append((f"unaligned_words_{offset}",
                      rng.random((2, 33, 2480)) < 0.5, offset))
    return cases

def _bars(h: int, w: int) -> np.ndarray:
    """Isolated clusters of 1 to 17 pixels: bars along the rows, the
    columns and the diagonal, and blocks filled row by row four pixels
    wide. Every size k and k + 1 of the certificates' k = 2j, j <= 8."""
    plane = np.zeros((h, w), bool)
    x = 2
    for n in range(1, 18):           # rows
        plane[2, x: x + n] = True
        x += n + 2
    for n in range(1, 18):           # columns
        plane[6: 6 + n, 2 + 3 * n] = True
    x = 2
    for n in range(1, 18):           # diagonals
        for i in range(n):
            plane[26 + i, x + i] = True
        x += n + 2
    for n in range(1, 18):           # blocks
        for i in range(n):
            plane[48 + i // 4, 2 + 7 * n + i % 4] = True
    return plane


# names of `cert_cases`, in order; pages of one shape share the
# reference's compiles in the CPU tests
CERT_CASE_NAMES = ("h1_w1_pixel", "h1_w300", "h300_w1", "h70_w45_b2",
                   "h64_w130", "h33_w257", "full_h100_w96", "empty_h100_w96",
                   "borders_h64_w130", "bars_h60_w330_b2",
                   "uint8_values_h40_w272_b2", "unaligned_view")


def cert_cases(seed: int = 0) -> list:
    """Edge cases of the certificate sweep, as (name, plane [B,H,W] bool or
    uint8, offset) in the order of `CERT_CASE_NAMES`: a one-pixel page,
    single-row and single-column pages, random planes of widths that are
    no multiple of 32 (257: past the kernel's 256-column block; 33 rows: a
    word row and one row), a full
    and an empty page, isolated pixels and small clusters at the four
    borders, the clusters of `_bars` (page 1 is page 0 turned by 180
    degrees), a uint8 plane of values 0 to 255 (each non-zero byte is a
    mask pixel), and a view whose data pointer is not 16-byte aligned
    (`offset`: hand the plane to the kernel through `offset_view`)."""
    rng = np.random.default_rng(seed)
    cases = [("h1_w1_pixel", np.ones((1, 1, 1), bool), 0),
             ("h1_w300", rng.random((1, 1, 300)) < 0.5, 0),
             ("h300_w1", rng.random((1, 300, 1)) < 0.5, 0),
             ("h70_w45_b2", rng.random((2, 70, 45)) < 0.3, 0),
             ("h64_w130", rng.random((1, 64, 130)) < 0.35, 0),
             ("h33_w257", rng.random((1, 33, 257)) < 0.3, 0),
             ("full_h100_w96", np.ones((1, 100, 96), bool), 0),
             ("empty_h100_w96", np.zeros((1, 100, 96), bool), 0)]
    h, w = 64, 130
    plane = np.zeros((1, h, w), bool)
    for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, 40),
                 (h - 1, 41), (30, 0), (31, w - 1), (0, 10), (1, 11),
                 (h - 1, 60), (h - 1, 61), (h - 1, 62), (50, w - 1),
                 (51, w - 1), (52, w - 1), (20, 0), (21, 1), (22, 0)):
        plane[0, y, x] = True
    cases.append(("borders_h64_w130", plane, 0))
    bars = _bars(60, 330)
    cases.append(("bars_h60_w330_b2", np.stack([bars, bars[::-1, ::-1]]), 0))
    values = rng.integers(0, 256, (2, 40, 272), dtype=np.uint8)
    values[rng.random(values.shape) < 0.6] = 0
    cases.append(("uint8_values_h40_w272_b2", values, 0))
    cases.append(("unaligned_view", rng.random((2, 40, 272)) < 0.3, 1))
    assert tuple(c[0] for c in cases) == CERT_CASE_NAMES
    return cases
