"""Scan-like pages made from a seed: the benchmark's own generator.

Grown from the port's `utils/pages.synthetic_pages` and `text_pages` (a
black border, 3-px text lines, rows of I, L and T glyphs of 5-px
strokes, a gray block and about 500 speckles), frozen here and extended
so that every page differs: from the seed and the page's index it draws
which sides have a border and how wide, the bands of text lines and
glyph rows and where they lie, each stroke's ink, dark speckles and
light dust, and a shaded block whose gray ramps across its width (so
that every gray level, the dark threshold's included, occurs on a page;
the dust's grays lie about the non-white threshold).

A cell's `content` parameters set the mix: the bands' height and the
share of them that are text lines, glyph rows or empty; the glyphs'
pitch, height, stroke and darkest ink; the text's margin (null: an
eighth of the width and a twelfth of the height, a sixth at the top
under a letterhead); whether pages have scan borders (every run of 16
pages takes each subset of the four sides once, so that every seed asks
for the same work); a thin dark frame at the rim; the speckle count;
where the shaded block lies: among the text (a figure the text flows
around), in the top margin (a letterhead) or nowhere. Sizes in pixels
are given at 300 dpi and scale with the page's dpi.
"""

from __future__ import annotations

import numpy as np


def page_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of page `index` under `seed` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), int(index)])


def _word(v) -> np.uint32:
    """An opaque gray pixel of value v as an RGBA word (R the low byte)."""
    return np.uint32(0xFF000000 | (int(v) * 0x010101))


def make_page(seed: int, index: int, h: int, w: int, dpi: int,
              content: dict, out: np.ndarray | None = None) -> np.ndarray:
    """uint8 RGBA [h, w, 4], alpha 255 (drawn into `out` if given)."""
    rng = page_rng(seed, index)
    s = dpi / 300.0
    page = np.empty((h, w, 4), np.uint8) if out is None else out
    words = page.view(np.uint32).reshape(h, w)
    words[:] = _word(rng.integers(236, 251))
    avoid = None
    if content["block"] == "text":     # a figure among the text
        bh = int(rng.integers(h // 10, h // 6))
        bw = int(rng.integers(w // 8, w // 4))
        y0 = int(rng.integers(h // 10, h - h // 10 - bh))
    elif content["block"] == "margin":  # a letterhead above the text
        bh = int(rng.integers(h // 40, h // 20))
        bw = int(rng.integers(w // 8, w // 4))
        top = h // 25 + 10
        y0 = int(rng.integers(top, max(top + 1, h // 6 - int(48 * s) - bh)))
    if content["block"]:
        x0 = int(rng.integers(w // 10, w - w // 10 - bw))
        ramp = np.linspace(int(rng.integers(15, 41)), 235,
                           bw).round().astype(np.uint32)
        words[y0:y0 + bh, x0:x0 + bw] = (0xFF000000 | ramp * 0x010101)[None]
        m = int(round(48 * s))  # text clear of it by more than two leaps
        avoid = (y0 - m, y0 + bh + m, x0 - m, x0 + bw + m)
    _bands(words, rng, s, content, avoid)
    n = int(rng.integers(*content["speckles"]))
    ys, xs = rng.integers(0, h, n), rng.integers(w // 20, w, n)
    words[ys, xs] = 0xFF000000 | rng.integers(0, 201, n).astype(np.uint32) * 0x010101
    # light dust: each channel 226-232, gray about the non-white threshold
    ys, xs = rng.integers(0, h, n // 4), rng.integers(0, w, n // 4)
    rgb = rng.integers(226, 233, (n // 4, 3)).astype(np.uint32)
    words[ys, xs] = 0xFF000000 | rgb[:, 0] | rgb[:, 1] << 8 | rgb[:, 2] << 16
    if content["borders"]:
        _borders(words, rng, border_sides(seed, index))
    frame = int(round(content["frame"] * s))
    if frame:
        ink = _word(rng.integers(0, 31))
        words[:frame] = words[h - frame:] = ink
        words[:, :frame] = words[:, w - frame:] = ink
    return page


def _bands(words, rng, s, content: dict, avoid) -> None:
    """Bands of `band` px (scaled) down the text area: each a text line,
    a glyph row or empty, as `content["bands"]` weighs them; none of it
    within the rectangle `avoid` (y0, y1, x0, x1), the shaded block's
    surround, as text flows around a figure."""
    h, w = words.shape
    mix, ink = content["bands"], content["ink"]
    kinds = list(mix)
    weights = np.asarray([mix[k] for k in kinds], np.float64)
    band = int(round(content["band"] * s))
    if content["margin"] is None:
        my, mx = h // 12, w // 8
        if content["block"] == "margin":
            my = h // 6
    else:
        my = mx = int(round(content["margin"] * s))
    starts = range(my, h - min(my, h // 12) - band, band)
    picks = rng.choice(len(kinds), size=len(starts), p=weights / weights.sum())
    for y, pick in zip(starts, picks):
        spans = [(mx, w - mx)]
        if avoid is not None and y < avoid[1] and y + band > avoid[0]:
            spans = [(mx, avoid[2]), (avoid[3], w - mx)]  # around the block
        for lo, hi in spans:
            if kinds[pick] == "line" and hi - lo > band:
                t = int(round(int(rng.integers(2, 5)) * s))
                words[y + band // 3: y + band // 3 + t, lo:hi] = _word(
                    rng.integers(0, ink + 1))
            elif kinds[pick] == "glyphs":
                _glyph_row(words, rng, s, y + int(round(4 * s)), lo, hi,
                           content["pitch"], content["glyph_height"],
                           content["stroke"], ink)


def _glyph_row(words, rng, s, top, left, right, pitch, height, stroke,
               ink) -> None:
    """I, L and T shapes of `stroke`-px strokes, `height` px high,
    one every `pitch` px, each with its own ink up to `ink`."""
    st, gh = int(round(stroke * s)), int(round(height * s))
    pitch = int(round(pitch * s))
    foot, bar, off = (int(round(v * s)) for v in (16, 17, 6))
    xs = range(left + int(rng.integers(0, pitch)), right - pitch, pitch)
    kinds = rng.integers(0, 3, len(xs))
    inks = 0xFF000000 | rng.integers(0, ink + 1, len(xs)).astype(
        np.uint32) * 0x010101
    for x, kind, ink in zip(xs, kinds, inks):
        stem = x + (off if kind == 2 else 0)
        words[top: top + gh, stem: stem + st] = ink
        if kind == 1:    # L: a foot to the right
            words[top + gh - st: top + gh, x: x + foot] = ink
        elif kind == 2:  # T: a bar across the top
            words[top: top + st, x: x + bar] = ink


def _borders(words, rng, sides: int) -> None:
    """A dark scan border on each side whose bit is set in `sides`
    (left, right, top, bottom), each of its own width and ink."""
    h, w = words.shape
    for side in range(4):
        if not sides >> side & 1:
            continue
        extent = w if side < 2 else h
        width = int(rng.integers(extent // 80, extent // 25))
        ink = _word(rng.integers(0, 31))
        if side == 0:
            words[:, :width] = ink
        elif side == 1:
            words[:, w - width:] = ink
        elif side == 2:
            words[:width] = ink
        else:
            words[h - width:] = ink


def border_sides(seed: int, index: int) -> int:
    """The sides with a border of page `index`: each run of 16 pages
    takes all 16 subsets of the four sides, in an order drawn from the
    seed, so that every seed asks for the same floods."""
    group = np.random.default_rng([int(seed) % (1 << 64), index // 16, 16])
    return int(group.permutation(16)[index % 16])


def make_pages(seed: int, first: int, n: int, h: int, w: int, dpi: int,
               content: dict) -> np.ndarray:
    """Pages first .. first + n - 1 of `seed`: uint8 RGBA [n, h, w, 4]."""
    out = np.empty((n, h, w, 4), np.uint8)
    for i in range(n):
        make_page(seed, first + i, h, w, dpi, content, out[i])
    return out
