"""SWT, the Stroke Width Transform (port of `libpillowfight_tpu/ops/swt.py`).

The width maps keep the reference's formulation, so that they can be held
bit-identical to it on the same edges and gradients:

1. The edge map and the gradients come from the canny stack.
2. Ray directions are quantized to 16 integer vectors (axis, diagonal and
   knight moves); class k + 8 is the opposite of class k.
3. The first edge pixel along every class from every pixel comes from
   pointer doubling over static shifts, carried as one packed int32 plane
   (`_first_edge_along`, `_decode_chain`).
4. Stroke widths are committed without marching rays, by the segment
   identity (`_class_commit`): the only ray of class k through a pixel is
   the one anchored at its nearest upstream edge, and it ends at its
   nearest downstream edge.
5. Each ray's median (of its first 13 cells, the upper median) clamps the
   ray's cells in a second pass.

On a CUDA tensor the directions' quantization of step 2 and steps 3 to 5
are the kernels of `ops/cuda/swt_maps.py` (`csrc/swt_maps.cu`),
bit-identical to the plain passes below, which a CPU tensor takes.

What differs from the reference, where a gather is cheaper than a chain of
dense shifts on this hardware and the values are the same:

- the median is taken at the anchor pixels only (compacted), not on 13
  dense planes;
- a value pulled from a first-edge cell is gathered at the cell the packed
  chain state names, instead of riding the chain;
- the letter pass groups pixels by component label (`torch.unique`,
  `index_add_`, `scatter_reduce_`) instead of by row runs and sorted
  segments. Sums are taken in float64 and rounded to float32, so they do
  not depend on the order of the atomics; the reference's float32 sums
  round differently in the last place, which can move a component that
  sits exactly on a threshold.

Components of similar stroke width come from
`morph.label_components_links` (the label kernel on a CUDA tensor).

While a profiler runs, the width maps are the span `swt.width_maps`, with
the stream time of their device work, and each host read the span
`sync.swt_<site>` (`utils.metrics.span`).

Outputs (the reference's enum):
  SWT_OUTPUT_BW_TEXT         0: letter pixels black on white
  SWT_OUTPUT_GRAYSCALE_TEXT  1: letter pixels keep their gray on white
  SWT_OUTPUT_ORIGINAL_BOXES  2: the page with the letters' boxes in red
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import constants as C
from ..core.bitmap import (_third, ensure_batched, maybe_unbatch,
                           pages_to_words, shift2d, words_to_gray,
                           words_to_pages)
from ..utils.metrics import span
from .canny import canny_edge_mask_from_gradients, canny_gradients
from .cuda import swt_maps as maps_kernel
from .cuda.label import OFFSETS
from .morph import label_components_links

_INF = 1e9

# 16 direction vectors (dy, dx), ordered by angle; class k + 8 is the
# opposite direction. Knight moves carry an intermediate cell (the rounded
# half-step) so that a digital ray cannot jump a 1-px edge line.
_VECS = (
    (0, 1), (1, 2), (1, 1), (2, 1),
    (1, 0), (2, -1), (1, -1), (1, -2),
    (0, -1), (-1, -2), (-1, -1), (-2, -1),
    (-1, 0), (-2, 1), (-1, 1), (-1, 2),
)
_NDIR = len(_VECS)
_ANGLES = np.arctan2([v[0] for v in _VECS], [v[1] for v in _VECS])
_NORMS = np.hypot([v[0] for v in _VECS], [v[1] for v in _VECS])

_CHAIN_MISS = (16 << 11) | 2047
_MED_SAMPLES = 13  # ray cells 0..12 sampled for the median clamp

# pixels of one call of the width maps: larger batches go through in
# chunks of pages (about four A4 300 dpi pages; the plain passes hold 16
# int32 chain planes)
_MAPS_CHUNK_PIXELS = 36_000_000
# the same on a CUDA tensor, whose kernels hold ~25 bytes a pixel (the
# angles, the classes, a chain plane, two maps, two state planes): 16 A4
# 300 dpi pages (the runner's chunk) in one call
_KERNEL_MAPS_CHUNK_PIXELS = 150_000_000


def _half(v):
    """Intermediate cell of one v-step (knight moves only), else None."""
    w = (int(np.round(v[0] / 2.0)), int(np.round(v[1] / 2.0)))
    return w if w != (0, 0) and w != v else None


def _halves(v):
    """Intermediate cells of one v-step (knight moves), far to near, so
    that overwriting base-case hits leaves the nearest one."""
    h = _half(v)
    if h is None:
        return ()
    g = (v[0] - h[0], v[1] - h[1])
    return tuple(sorted({h, g}, key=lambda c: -np.hypot(*c)))


def _quantize_dirs(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """Nearest direction class (int8) of unit directions: the first class
    at the least distance on the circle."""
    return _quantize_angles(torch.atan2(uy, ux))


def _quantize_angles(ang: torch.Tensor) -> torch.Tensor:
    """`_quantize_dirs` of the directions' angles."""
    best = torch.full_like(ang, math.inf)
    cls = torch.zeros(ang.shape, dtype=torch.int8, device=ang.device)
    for k, a in enumerate(_ANGLES.astype(np.float32)):
        diff = (torch.remainder(ang - float(a) + math.pi, 2 * math.pi)
                - math.pi).abs()
        take = diff < best
        cls = torch.where(take, k, cls).to(torch.int8)
        best = torch.where(take, diff, best)
    return cls


def _hit_cell(enc: torch.Tensor, k: int) -> tuple:
    """(dy, dx) from every pixel to the first-edge cell its chain state
    names: u steps of v for a lattice hit, u - 1 steps plus the half cell
    for a hit at a knight intermediate. Garbage on a miss."""
    v = _VECS[k]
    halves = _halves(v)
    u = enc & 2047
    if not halves:
        return u * v[0], u * v[1]
    lat = ((enc >> 16) & 1) == 1
    second = (enc >> 17) & 1
    h0, h1 = halves[0], halves[-1]
    hy = h0[0] + second * (h1[0] - h0[0])
    hx = h0[1] + second * (h1[1] - h0[1])
    return (torch.where(lat, u * v[0], (u - 1) * v[0] + hy),
            torch.where(lat, u * v[1], (u - 1) * v[1] + hx))


def _pull(enc: torch.Tensor, k: int, payloads) -> list:
    """Each payload's value at the first-edge cell of every pixel, _INF
    on a miss."""
    if not payloads:
        return []
    h, w = enc.shape[-2:]
    dy, dx = _hit_cell(enc, k)
    hit = ((enc >> 11) & 31) < 16
    ys = torch.arange(h, device=enc.device).view(h, 1)
    xs = torch.arange(w, device=enc.device).view(1, w)
    flat = (torch.where(hit, (ys + dy) * w + (xs + dx), 0)
            .to(torch.int64).flatten(-2))
    return [torch.where(hit, p.flatten(-2).gather(-1, flat).view(enc.shape),
                        _INF) for p in payloads]


def _first_edge_along(edge_cls: torch.Tensor, k: int, t_units: int,
                      payloads=()):
    """First edge pixel along direction class k from every pixel.

    edge_cls int8 [..., H, W]: class at edge pixels, -1 elsewhere. Knight
    vectors check their intermediate cells first. After doubling step j
    the carry holds the first edge within 2^j v-steps.

    The carry is one int32 plane: u (bits 0..10, the v-step count), the
    hit's class (bits 11..15; 16 = miss), lat (bit 16: the hit lies on
    the lattice, not at a knight intermediate) and the index of the
    knight half (bit 17). `_decode_chain` unpacks it.

    payloads: f32 maps whose value at the first-edge cell is pulled back
    to every pixel (_INF on a miss). Returns (enc, *pulled)."""
    v = _VECS[k]
    ec = edge_cls.to(torch.int32)
    ev = shift2d(ec, v[0], v[1], -1)
    enc = torch.where(ev >= 0, 1 | (ev << 11) | (1 << 16), _CHAIN_MISS)
    for idx, hc in enumerate(_halves(v)):
        eh = shift2d(ec, hc[0], hc[1], -1)
        enc = torch.where(eh >= 0, 1 | (eh << 11) | (idx << 17), enc)
    step = 1
    while step < t_units:
        enc2 = shift2d(enc, step * v[0], step * v[1], _CHAIN_MISS)
        take = (((enc >> 11) & 31) == 16) & (((enc2 >> 11) & 31) != 16)
        enc = torch.where(take, enc2 + step, enc)
        step *= 2
    return (enc, *_pull(enc, k, payloads))


def _decode_chain(enc: torch.Tensor, k: int):
    """Packed chain state -> (d f32, u i32, c i32, lat bool); _INF, -,
    -1, False on a miss."""
    nv = float(np.float32(_NORMS[k]))
    halves = _halves(_VECS[k])
    u = enc & 2047
    c5 = (enc >> 11) & 31
    hit = c5 < 16
    lat = ((enc >> 16) & 1) == 1
    uf = u.to(torch.float32)
    d = uf * nv
    if halves:
        # (u - 1) * |v| + |half| is a fused multiply-add in the
        # reference's compiled program: one rounding. In float64 the
        # product and the sum are exact, so rounding once gives the same.
        h0 = float(np.float32(np.hypot(*halves[0])))
        h1 = float(np.float32(np.hypot(*halves[-1])))
        hsel = h0 + ((enc >> 17) & 1).to(torch.float64) * (h1 - h0)
        knight = ((u - 1).to(torch.float64) * nv + hsel).to(torch.float32)
        d = torch.where(lat, d, knight)
    d = torch.where(hit, d, _INF)
    c = torch.where(hit, c5, -1)
    return d, u, c, lat & hit


def _opposing(hit_cls: torch.Tensor, k: int) -> torch.Tensor:
    """The hit's gradient class is within one class of opposite to k
    (the pi/6 cone: class spacing alternates 18.4 and 26.6 degrees)."""
    diff = torch.remainder(hit_cls.to(torch.int32) - (k + _NDIR // 2), _NDIR)
    return (hit_cls >= 0) & ((diff <= 1) | (diff >= _NDIR - 1))


def _class_commit(k: int, s: int, down, up, edge_cls, is_edge, t_units,
                  payload_up=None, payload_anchor=None):
    """Committed value map of (class k, sign s) by the segment pull.

    down/up = decoded chains along k and k + 8. A pixel's only class-k
    committer is its nearest upstream edge e1, and the ray ends at its
    nearest downstream edge e2. With payload_up (the value pulled from
    e1: the ray median) that value is committed instead of the width;
    payload_anchor is what an anchor commits to itself.

    Returns (contrib f32, is_anchor bool, u_dn i32); contrib includes the
    knight moves' intermediate cells."""
    d_dn, u_dn, c_dn = down[0], down[1], down[2]
    d_up, u_up, c_up, lat_up = up
    # an edge of gradient class c casts along c (sign +1) or c + 8 (-1)
    src = (k - (_NDIR // 2 if s == -1 else 0)) % _NDIR
    anchor_up_ok = (c_up == src) & lat_up
    hit_dn_ok = _opposing(c_dn, src)
    mid_ok = ~is_edge & anchor_up_ok & hit_dn_ok & (u_up + u_dn <= t_units)
    hit_ok = (is_edge & anchor_up_ok & _opposing(edge_cls, src)
              & (u_up <= t_units))
    is_anchor = (edge_cls == src) & hit_dn_ok & (u_dn <= t_units)
    inf = torch.full_like(d_dn, _INF)
    if payload_up is None:
        w_mid = torch.where(mid_ok, (d_up + d_dn).clamp(min=1.0), inf)
        w_hit = torch.where(hit_ok, d_up.clamp(min=1.0), inf)
        w_anc = torch.where(is_anchor, d_dn.clamp(min=1.0), inf)
    else:
        w_mid = torch.where(mid_ok, payload_up, inf)
        w_hit = torch.where(hit_ok, payload_up, inf)
        w_anc = (torch.where(is_anchor, payload_anchor, inf)
                 if payload_anchor is not None else inf)
    contrib = torch.minimum(torch.minimum(w_mid, w_hit), w_anc)
    half = _half(_VECS[k])
    if half is not None:
        # a knight ray also covers the half-step cell after every covered
        # cell but the hit
        w_prev = torch.minimum(w_mid, w_anc)
        contrib = torch.minimum(
            contrib, shift2d(w_prev, -half[0], -half[1], _INF))
    return contrib, is_anchor, u_dn


def _t_units(k: int, max_len: int) -> int:
    return max(int(np.ceil(max_len / _NORMS[k])), 1)


def _direction_table(max_len: int) -> tuple[list[int], list[float]]:
    """The 16 classes as the width-map kernels take them: for each, (dy,
    dx, 2 for a knight move else 0, its far and its near intermediate
    cell, t_units) and, in f32, (|v|, |far|, |near|, its angle); then pi
    and 2 pi in f32, as `_quantize_angles` compares in them. The near cell
    is the one a knight ray also covers (`_half`)."""
    ints, floats = [], []
    for k, v in enumerate(_VECS):
        halves = _halves(v) or ((0, 0), (0, 0))
        ints += [*v, len(_halves(v)), *halves[0], *halves[-1],
                 _t_units(k, max_len)]
        floats += [float(np.float32(x)) for x in
                   (_NORMS[k], np.hypot(*halves[0]), np.hypot(*halves[-1]),
                    _ANGLES[k])]
    return ints, floats + [float(np.float32(math.pi)),
                           float(np.float32(2 * math.pi))]


def _pairs(chains, k):
    """(class, down, up, chain the up side was decoded from) for class k
    and its opposite."""
    o = k + _NDIR // 2
    dec_k, dec_o = _decode_chain(chains[k], k), _decode_chain(chains[o], o)
    return ((k, dec_k, dec_o, o), (o, dec_o, dec_k, k))


def _width_pass(edge_cls: torch.Tensor, max_len: int):
    """Pass 1: the 16 first-edge chains, both signs' width maps and the
    packed anchor state (bits 0..10 the ray's units, 11..15 its class,
    bit 16 is-anchor)."""
    is_edge = edge_cls >= 0
    chains = [_first_edge_along(edge_cls, k, _t_units(k, max_len))[0]
              for k in range(_NDIR)]
    shape, dev = edge_cls.shape, edge_cls.device
    swt = {s: torch.full(shape, _INF, dtype=torch.float32, device=dev)
           for s in (-1, 1)}
    a_enc = {s: torch.zeros(shape, dtype=torch.int32, device=dev)
             for s in (-1, 1)}
    for k in range(_NDIR // 2):
        for kk, down, up, _ in _pairs(chains, k):
            for s in (-1, 1):
                contrib, is_anchor, u_dn = _class_commit(
                    kk, s, down, up, edge_cls, is_edge, _t_units(kk, max_len))
                swt[s] = torch.minimum(swt[s], contrib)
                a_enc[s] = torch.where(
                    is_anchor, u_dn | (kk << 11) | (1 << 16), a_enc[s])
    return chains, swt, a_enc


def _ray_medians(swt_s: torch.Tensor, a_enc_s: torch.Tensor) -> torch.Tensor:
    """The median map of one sign: at each anchor, the upper median of
    the first min(u + 1, 13) cells of its ray; _INF elsewhere. Exact for
    rays of up to 13 cells."""
    h, w = swt_s.shape[-2:]
    med_map = torch.full_like(swt_s, _INF)
    with span("sync.swt_ray_medians"):
        idx = ((a_enc_s >> 16) != 0).flatten().nonzero().squeeze(1)
    if idx.numel() == 0:
        return med_map
    state = a_enc_s.flatten()[idx]
    u, kcls = state & 2047, ((state >> 11) & 31).to(torch.int64)
    with span("sync.swt_ray_vectors"):  # a copy to the card waits too
        vecs = torch.tensor(_VECS, dtype=torch.int64, device=swt_s.device)
    rem = idx % (h * w)
    j = torch.arange(_MED_SAMPLES, device=swt_s.device)
    yy = (rem // w)[:, None] + j * vecs[kcls, 0][:, None]
    xx = (rem % w)[:, None] + j * vecs[kcls, 1][:, None]
    ok = ((j <= u[:, None]) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))
    cell = (idx - rem)[:, None] + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    vals = torch.where(ok, swt_s.flatten()[cell], _INF).sort(dim=1).values
    mid = (torch.clamp(u + 1, max=_MED_SAMPLES) // 2).to(torch.int64)
    med_map.view(-1)[idx] = vals.gather(1, mid[:, None]).squeeze(1)
    return med_map


def _median_pass(edge_cls, chains, swt, med_map, max_len: int) -> dict:
    """Pass 2: every ray's cells clamped to the ray's median, pulled from
    the upstream anchor along the same segments."""
    is_edge = edge_cls >= 0
    res = {s: torch.minimum(swt[s], med_map[s]) for s in (-1, 1)}
    for k in range(_NDIR // 2):
        for kk, down, up, up_k in _pairs(chains, k):
            pulled = _pull(chains[up_k], up_k, (med_map[-1], med_map[1]))
            for si, s in enumerate((-1, 1)):
                contrib, _, _ = _class_commit(
                    kk, s, down, up, edge_cls, is_edge,
                    _t_units(kk, max_len), payload_up=pulled[si],
                    payload_anchor=med_map[s])
                res[s] = torch.minimum(res[s], contrib)
    return res


def _gradient_angles(gx, gy) -> torch.Tensor:
    """The angles of the unit gradients, which `_edge_classes` quantizes."""
    norm = torch.sqrt(gx * gx + gy * gy).clamp(min=1e-6)
    return torch.atan2(gy / norm, gx / norm)


def _edge_classes(edges, gx, gy) -> torch.Tensor:
    """Gradient class (int8) at edge pixels, -1 elsewhere."""
    cls = _quantize_angles(_gradient_angles(gx, gy))
    return torch.where(edges, cls, -1).to(torch.int8)


def _width_maps_plain(edge_cls: torch.Tensor, max_len: int):
    """Steps 3 to 5 in plain torch: (swt_minus, swt_plus, n_anchors) of
    edge classes [..., H, W]."""
    chains, swt, a_enc = _width_pass(edge_cls, max_len)
    n_anchors = (((a_enc[-1] | a_enc[1]) >> 16) != 0).sum(
        dim=(-2, -1), dtype=torch.int32)
    med_map = {s: _ray_medians(swt[s], a_enc[s]) for s in (-1, 1)}
    res = _median_pass(edge_cls, chains, swt, med_map, max_len)
    return res[-1], res[1], n_anchors


def _swt_maps_one(gray, edges, gx, gy, max_len):
    """Both polarities' stroke-width maps, for one page [H,W] or a batch
    [B,H,W]. gx/gy are the smoothed gradients shared with canny; gray is
    not read (the reference's signature). On a CUDA tensor the kernels
    take the gradients' angles from torch and do the rest.

    Returns (swt_minus, swt_plus, n_anchors): f32 maps (_INF = no
    stroke), sign -1 marching against the gradient (dark strokes on a
    light page), +1 along it; n_anchors int32 per page."""
    if not maps_kernel.use_kernel(edges, gx, gy):
        return _width_maps_plain(_edge_classes(edges, gx, gy), max_len)
    one = edges.ndim == 2
    ang, edges = _gradient_angles(gx, gy), edges.contiguous()
    out = maps_kernel.swt_maps_cuda(ang[None] if one else ang,
                                    edges[None] if one else edges,
                                    *_direction_table(max_len))
    return tuple(x[0] for x in out) if one else out


# --------------------------------------------------------------------------
# letter components
# --------------------------------------------------------------------------

def _gray_hist(gray: torch.Tensor) -> torch.Tensor:
    """Histogram of 3 * gray (values k/3, k in 0..765) of each plane
    [B,H,W] (or row block of a page): int64 [B,766]."""
    b = gray.shape[0]
    s3 = torch.round(gray * 3.0).to(torch.int64)
    page = torch.arange(b, device=gray.device).view(b, 1, 1)
    with span("sync.swt_gray_hist"):  # bincount reads its input's max
        return torch.bincount((s3 + 766 * page).flatten(),
                              minlength=766 * b).view(b, 766)


def _median_from_hist(hist: torch.Tensor, ntot: int) -> torch.Tensor:
    """Exact median of each page from its `_gray_hist` (summed over its
    row blocks) and its pixel count: [B] f32; an even count takes the
    mean of the two middle values."""
    b = hist.shape[0]
    cum = hist.cumsum(1)

    def kth(k):  # smallest value whose cumulative count reaches rank k
        rank = torch.full((b, 1), k, dtype=cum.dtype, device=cum.device)
        return _third(torch.searchsorted(cum, rank).squeeze(1))

    if ntot % 2:
        return kth((ntot + 1) // 2)
    return (kth(ntot // 2) + kth(ntot // 2 + 1)) / 2.0


def _median_gray(gray: torch.Tensor) -> torch.Tensor:
    """Exact median of each gray plane [B,H,W]: [B] f32."""
    return _median_from_hist(_gray_hist(gray), gray.shape[-2] * gray.shape[-1])


def _letter_select(gray, swt_minus, swt_plus, med):
    """(swt, valid, neg) of a page's pixels: the dark-on-light width where
    the pixel is darker than the page median `med`, the light-on-dark one
    where it is lighter, _INF (not valid) where it equals it."""
    neg = gray < med
    swt = torch.where(neg, swt_minus,
                      torch.where(gray > med, swt_plus, _INF))
    return swt, swt < _INF, neg


def _letter_links(swt, valid, neg) -> dict:
    """Links between neighbours of the same polarity whose stroke widths
    differ by no more than SWT_CC_SW_RATIO."""
    links = {}
    for dy, dx in OFFSETS:
        other = shift2d(swt, dy, dx, _INF)
        ratio = (torch.maximum(swt, other)
                 / torch.minimum(swt, other).clamp(min=1e-6))
        links[(dy, dx)] = (valid & shift2d(valid, dy, dx, False)
                           & (ratio <= C.SWT_CC_SW_RATIO)
                           & (neg == shift2d(neg, dy, dx, False)))[None]
    return links


def _run_starts(valid, lab, background: int) -> torch.Tensor:
    """Pixels that start a row run: a maximal same-label span of a row."""
    return valid & (lab != shift2d(lab, 0, -1, background))


def _within_run_cap(run_start, max_runs: int, before: int = 0):
    """Pixels whose row run is among the first max_runs of the page in
    row-major order, `before` runs lying in the page's rows above."""
    rank = run_start.flatten().cumsum(0) - 1 + before
    return (rank < max_runs).view(run_start.shape)


def _component_table(lab, kept, swt, neg, row0: int = 0):
    """The per-component table of the kept pixels of a page's rows [h,W]
    from row0, grouped by label: (labels int [nc] ascending, the group of
    each kept pixel [nk], the kept pixels' flat indices in these rows
    [nk], table). The table holds the pixel count and the sums of the
    stroke width and its square in float64 (partial sums that add across
    row blocks), the box extremes in page rows and columns (int64), and
    the polarity (the links join equal polarity only)."""
    w = lab.shape[-1]
    dev = lab.device
    with span("sync.swt_component_table"):
        vidx = kept.flatten().nonzero().squeeze(1)
        comp, inv = torch.unique(lab.flatten()[vidx], return_inverse=True)
    nc = comp.numel()
    sw = swt.flatten()[vidx].to(torch.float64)
    ys, xs = vidx // w + row0, vidx % w

    def total(values):
        return torch.zeros(nc, dtype=torch.float64, device=dev).index_add_(
            0, inv, values)

    def extreme(values, start, how):
        return torch.full((nc,), start, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, inv, values, how)

    big = 1 << 40
    table = {"cnt": total(torch.ones_like(sw)), "s1": total(sw),
             "s2": total(sw * sw),
             "ymin": extreme(ys, big, "amin"), "ymax": extreme(ys, -1, "amax"),
             "xmin": extreme(xs, big, "amin"), "xmax": extreme(xs, -1, "amax"),
             "neg": extreme(neg.flatten()[vidx].to(torch.int64), 0, "amax")}
    return comp, inv, vidx, table


def _decide(table: dict, max_letters: int):
    """The letters of a page's component table (labels ascending).

    A component is a letter if it has enough pixels, a steady stroke
    width, a moderate aspect and diameter, and a letter's height; one
    whose box holds more than SWT_MAX_NESTED_LETTERS other letters'
    boxes of its polarity is a frame and is dropped. The nesting test and
    the boxes take the first max_letters letters by label.

    Returns (keep bool [nc], boxes int32 [max_letters,4] as (y0, y1, x0,
    x1), boxes_ok bool [max_letters], n_letters)."""
    cnt, s1, s2 = (table[k].to(torch.float32) for k in ("cnt", "s1", "s2"))
    ymin, ymax, xmin, xmax = (table[k] for k in ("ymin", "ymax", "xmin",
                                                 "xmax"))
    dev = cnt.device
    mean_sw = s1 / cnt
    var_sw = (s2 / cnt - mean_sw * mean_sw).clamp(min=0.0)
    bw = (xmax - xmin + 1).to(torch.float32)
    bh = (ymax - ymin + 1).to(torch.float32)
    diag = torch.sqrt(bw * bw + bh * bh)
    aspect = torch.maximum(bw, bh) / torch.minimum(bw, bh).clamp(min=1.0)
    ok = ((cnt >= C.SWT_LETTER_MIN_PIXELS)
          & (var_sw <= C.SWT_LETTER_VARIANCE_RATIO * mean_sw * mean_sw)
          & (aspect <= C.SWT_LETTER_ASPECT_RATIO_MAX)
          & (diag < C.SWT_LETTER_DIAMETER_SW_RATIO * mean_sw.clamp(min=1e-6))
          & (bh >= C.SWT_LETTER_HEIGHT_MIN)
          & (bh <= C.SWT_LETTER_HEIGHT_MAX))
    n_letters = ok.sum(dtype=torch.int32)

    with span("sync.swt_letters"):
        acc = ok.nonzero().squeeze(1)[:max_letters]
    y0, y1, x0, x1 = ymin[acc], ymax[acc], xmin[acc], xmax[acc]
    r_neg = table["neg"][acc]
    contains = ((y0[:, None] <= y0[None, :]) & (y1[:, None] >= y1[None, :])
                & (x0[:, None] <= x0[None, :]) & (x1[:, None] >= x1[None, :])
                & (r_neg[:, None] == r_neg[None, :]))
    contains.fill_diagonal_(False)
    rejected = contains.sum(1) > C.SWT_MAX_NESTED_LETTERS
    keep = ok.clone()
    with span("sync.swt_nested"):
        keep[acc[rejected]] = False
    boxes = torch.zeros((max_letters, 4), dtype=torch.int32, device=dev)
    boxes_ok = torch.zeros(max_letters, dtype=torch.bool, device=dev)
    boxes[:acc.numel()] = torch.stack([y0, y1, x0, x1], dim=-1).to(torch.int32)
    boxes_ok[:acc.numel()] = ~rejected
    return keep, boxes, boxes_ok, n_letters


def _letter_mask_one(gray, swt_minus, swt_plus, med, max_letters, max_runs):
    """The letter candidates among one page's SWT components, both
    polarities in one labelling.

    The dark-on-light pass keeps only pixels darker than the page median,
    the light-on-dark pass only lighter ones, so the two sets are
    disjoint and share one plane; links join equal polarity only.

    max_runs bounds the row runs (maximal same-component spans of a row,
    in row-major order) that take part, as in the reference; max_letters
    bounds the letters that get a box and the nesting test (`_decide`).

    Returns (mask bool [H,W], boxes int32 [max_letters,4] as (y0, y1,
    x0, x1), boxes_ok bool [max_letters], n_runs, n_letters)."""
    h, w = swt_minus.shape
    n = h * w
    swt, valid, neg = _letter_select(gray, swt_minus, swt_plus, med)
    labels = label_components_links(
        valid[None], _letter_links(swt, valid, neg))[0]
    lab = torch.where(valid, labels, n)
    run_start = _run_starts(valid, lab, n)
    n_runs = run_start.sum(dtype=torch.int32)
    kept = valid
    with span("sync.swt_runs"):
        over = int(n_runs) > max_runs
    if over:  # the runs past the cap take no part
        kept = valid & _within_run_cap(run_start, max_runs)
    _, inv, vidx, table = _component_table(lab, kept, swt, neg)
    keep, boxes, boxes_ok, n_letters = _decide(table, max_letters)
    mask = torch.zeros(n, dtype=torch.bool, device=swt.device)
    mask[vidx] = keep[inv]
    return mask.view(h, w), boxes, boxes_ok, n_runs, n_letters


def _letter_mask(gray, swt_minus, swt_plus, max_letters, max_runs):
    """The letter pass of a batch, page by page (each page's component
    tables have their own size)."""
    med = _median_gray(gray)
    outs = [_letter_mask_one(gray[i], swt_minus[i], swt_plus[i], med[i],
                             max_letters, max_runs)
            for i in range(gray.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


# --------------------------------------------------------------------------
# public op
# --------------------------------------------------------------------------

def _boxes_on_mask(boxes, boxes_ok, h: int, w: int, row0: int = 0,
                   n_rows: int | None = None) -> torch.Tensor:
    """The boxes' perimeters on the page rows [row0, row0 + n_rows)
    (default: all h) as a bool [B,n_rows,W] mask, from boxes int32
    [B,N,4] = (y0, y1, x0, x1) in page rows and boxes_ok bool [B,N]: each
    side is a +1/-1 pair in a difference plane, summed along its axis; a
    vertical side is cut to the rows drawn."""
    n_rows = h - row0 if n_rows is None else n_rows
    b = boxes.shape[0]
    dev = boxes.device
    hor = torch.zeros((b, n_rows, w + 1), dtype=torch.int32, device=dev)
    ver = torch.zeros((b, n_rows + 1, w), dtype=torch.int32, device=dev)
    with span("sync.swt_boxes"):  # nonzero and the masked indexing
        bi, ni = boxes_ok.nonzero(as_tuple=True)
        y0, y1, x0, x1 = (boxes[bi, ni].to(torch.int64) - torch.tensor(
            [row0, row0, 0, 0], device=dev)).unbind(-1)
        one = torch.ones(bi.shape, dtype=torch.int32, device=dev)
        for y in (y0, y1):
            on = (y >= 0) & (y < n_rows)
            hor.index_put_((bi[on], y[on], x0[on]), one[on], accumulate=True)
            hor.index_put_((bi[on], y[on], x1[on] + 1), -one[on],
                           accumulate=True)
        top, bottom = y0.clamp(min=0), y1.clamp(max=n_rows - 1)
        on = top <= bottom
        for x in (x0, x1):
            ver.index_put_((bi[on], top[on], x[on]), one[on],
                           accumulate=True)
            ver.index_put_((bi[on], bottom[on] + 1, x[on]), -one[on],
                           accumulate=True)
    return ((hor.cumsum(2)[:, :, :w] > 0) | (ver.cumsum(1)[:, :n_rows] > 0))


def _gray_word(v: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """A byte value v in the R, G and B bytes of a word."""
    return alpha | v | (v << 8) | (v << 16)


def check_args(output_type: int, max_len: int) -> None:
    if max_len > 1023:
        raise ValueError(
            f"max_len={max_len} exceeds 1023: the first-edge chain packs "
            f"the step count into bits 0..10 (it reaches 2 * max_len), so "
            f"longer rays would carry into the class bits")
    if output_type not in (C.SWT_OUTPUT_BW_TEXT, C.SWT_OUTPUT_GRAYSCALE_TEXT,
                           C.SWT_OUTPUT_ORIGINAL_BOXES):
        raise ValueError(f"unknown swt output_type {output_type}")


def caps(h: int, w: int, max_letters: int | None, max_runs: int | None,
         max_valid: int | None) -> tuple[int, int]:
    """(max_letters, max_runs) of an H x W page, their defaults filled."""
    if max_runs is None:
        max_runs = max_valid if max_valid is not None else max(h * w // 32,
                                                               1024)
    if max_letters is None:
        max_letters = max(h * w // 2048, 1024)
    return max_letters, max_runs


def swt_maps(edges, gx, gy, max_len: int):
    """Both polarities' width maps and the anchors of a batch [B,H,W],
    `_MAPS_CHUNK_PIXELS` (`_KERNEL_MAPS_CHUNK_PIXELS` on a CUDA tensor) at
    a time."""
    b, h, w = edges.shape
    chunk = (_KERNEL_MAPS_CHUNK_PIXELS if maps_kernel.use_kernel(edges)
             else _MAPS_CHUNK_PIXELS)
    step = max(1, chunk // (h * w))
    with span("swt.width_maps", device=edges):
        parts = [_swt_maps_one(None, edges[i:i + step], gx[i:i + step],
                               gy[i:i + step], max_len)
                 for i in range(0, b, step)]
        return tuple(torch.cat(x) for x in zip(*parts))


def compose(words, gray, output_type: int, letter=None, on_box=None):
    """The output words: the letters (mode 0 black, mode 1 their gray) on
    white, or the page with the boxes' perimeters `on_box` in red
    (mode 2); alpha kept."""
    alpha = words & -0x1000000  # the alpha byte, as int32 bits
    if output_type == C.SWT_OUTPUT_ORIGINAL_BOXES:
        return torch.where(on_box, alpha | 0xFF, words)  # red
    if output_type == C.SWT_OUTPUT_BW_TEXT:
        ink = torch.full_like(words, C.PF_BLACK)
    else:
        ink = torch.round(gray).clamp(0, 255).to(torch.int32)
    return _gray_word(torch.where(letter, ink, C.PF_WHITE), alpha)


def swt(pages: torch.Tensor, output_type: int = C.SWT_OUTPUT_BW_TEXT,
        max_rays: int | None = None, max_len: int = C.SWT_MAX_RAY_LEN,
        max_letters: int | None = None, max_runs: int | None = None,
        max_edges: int | None = None, max_valid: int | None = None,
        return_debug: bool = False):
    """Stroke Width Transform. uint8 RGBA [B,H,W,4] or int32 words
    [B,H,W] (or one page) in; the same form out, on the input's device.

    max_rays and max_edges are accepted and ignored, as in the
    reference: the median clamp has no ray list to truncate. max_len
    bounds a ray in pixels (<= 1023: the chain state packs the step
    count into 11 bits). max_runs bounds the row runs of the letter
    statistics (default H*W // 32; max_valid is its older name);
    max_letters bounds the letters that get a box (default
    max(1024, H*W // 2048)).

    return_debug=True also returns {"n_anchors", "n_runs", "n_letters"}
    (int32 per page) and the caps: compare n_x with max_x to see that no
    cap cut a run short."""
    check_args(output_type, max_len)
    pages, unb = ensure_batched(pages)
    in_words = pages.dtype == torch.int32
    if not in_words and pages.dtype != torch.uint8:
        raise TypeError(f"pages must be uint8 RGBA or int32 words, got "
                        f"{pages.dtype}")
    words = pages if in_words else pages_to_words(pages)
    gray = words_to_gray(words)
    b, h, w = gray.shape
    max_letters, max_runs = caps(h, w, max_letters, max_runs, max_valid)

    ggx, ggy = canny_gradients(gray)
    edges = canny_edge_mask_from_gradients(ggx, ggy)
    swt_minus, swt_plus, n_anchors = swt_maps(edges, ggx, ggy, max_len)
    del ggx, ggy, edges
    letter, boxes, boxes_ok, n_runs, n_letters = _letter_mask(
        gray, swt_minus, swt_plus, max_letters, max_runs)
    on_box = (_boxes_on_mask(boxes, boxes_ok, h, w)
              if output_type == C.SWT_OUTPUT_ORIGINAL_BOXES else None)
    out = compose(words, gray, output_type, letter, on_box)
    if not in_words:
        out = words_to_pages(out)
    out = maybe_unbatch(out, unb)
    if return_debug:
        return out, {"n_anchors": n_anchors, "n_runs": n_runs,
                     "max_runs": max_runs, "n_letters": n_letters,
                     "max_letters": max_letters}
    return out
