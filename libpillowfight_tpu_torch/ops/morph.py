"""Flood fill, component labels, small-cluster mask and the 3 x 3
neighbourhood maxima and minima (port of `libpillowfight_tpu/ops/morph.py`).

The 8-connected flood, the labels and the small-cluster mask up to k = 15
run through the wrappers of `ops/cuda`: the hand-written kernels for CUDA
tensors, their plain PyTorch versions for CPU tensors. The 4-connected
flood, the small-cluster mask from k = 16 and the neighbourhood helpers
are plain torch on either device, as the reference runs them outside any
kernel. The flood and the labels are exact fixed points, so their results
do not depend on the round structure, only on the connectivity.

While a profiler runs, each 8-connected flood of `flood_reach` is the span
`flood` and counts its rounds as `flood.rounds` (`utils.metrics`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.bitmap import shift2d
from ..utils import metrics
from .cuda import flood_packed as fp
from .cuda import flood_sweep as fs
from .cuda.flood_packed import flood_packed, lsr, pack_rows, unpack_rows
from .cuda.flood_sweep import _seg_or, flood_sweep
from .cuda.label import label_links, mask_links
from .cuda.noise import _i32, _popcount, noise_ball, small_cluster_mask_cert


def _window3(x: torch.Tensor, fill, op, plus: bool) -> torch.Tensor:
    """`op` over the 3 x 3 window (the plus-shaped one if `plus`) of a
    [B,H,W] plane, `fill` outside the page."""
    def along(t, dy, dx):
        return op(op(shift2d(t, -dy, -dx, fill), t), shift2d(t, dy, dx, fill))

    if plus:
        return op(along(x, 0, 1), along(x, 1, 0))
    return along(along(x, 0, 1), 1, 0)


def _lowest(x: torch.Tensor):
    if x.dtype == torch.bool:
        return False
    return float("-inf") if x.dtype.is_floating_point \
        else torch.iinfo(x.dtype).min


def _max_op(x: torch.Tensor):
    return torch.logical_or if x.dtype == torch.bool else torch.maximum


def _min_op(x: torch.Tensor):
    return torch.logical_and if x.dtype == torch.bool else torch.minimum


def dilate8(x: torch.Tensor) -> torch.Tensor:
    """3 x 3 max (8-neighbourhood) of a bool, integer or float [B,H,W]
    plane; outside the page counts as the type's lowest value."""
    return _window3(x, _lowest(x), _max_op(x), plus=False)


def dilate4(x: torch.Tensor) -> torch.Tensor:
    """Plus-shaped (4-neighbourhood) max."""
    return _window3(x, _lowest(x), _max_op(x), plus=True)


def erode_min8(x: torch.Tensor, big) -> torch.Tensor:
    """3 x 3 min (8-neighbourhood) of a [B,H,W] plane; outside the page
    counts as `big`."""
    return _window3(x, big, _min_op(x), plus=False)


def erode_min4(x: torch.Tensor, big) -> torch.Tensor:
    """Plus-shaped (4-neighbourhood) min, `big` outside the page."""
    return _window3(x, big, _min_op(x), plus=True)


def dilate_cheb(x: torch.Tensor, k: int) -> torch.Tensor:
    """Chebyshev-ball dilation of radius k of a bool [B,H,W] plane."""
    y = F.max_pool2d(x.to(torch.float32)[:, None], 2 * k + 1, stride=1,
                     padding=k)
    return y[:, 0] > 0


PACKED_LIMIT_BYTES = 1_500_000


def packed_fits(h: int, w: int) -> bool:
    """The reference's size test for its packed flood: the packed page,
    ceil(h/32) word rows of w rounded up to 128 lanes, 4 bytes a word,
    within 1.5 MB. A4 at 300 dpi fits, A4 at 600 dpi does not."""
    return ((h + 31) // 32) * ((w + 127) // 128 * 128) * 4 <= \
        PACKED_LIMIT_BYTES


def _flood4(seeds: torch.Tensor, mask: torch.Tensor,
            max_iters: int | None) -> torch.Tensor:
    """The reference's fixed point for 4-connectivity: rounds of segmented
    OR along the rows, along the columns, then a plus-shaped dilation gated
    by the mask, until a round changes nothing."""
    b, h, w = mask.shape
    r = seeds & mask
    for _ in range(h * w + 2 if max_iters is None else max_iters):
        new = _seg_or(mask, r, 2)
        new = _seg_or(mask, new, 1)
        new = (dilate4(new) & mask) | new
        with metrics.span("sync.flood4"):
            done = torch.equal(new, r)
        if done:
            break
        r = new
    return r


def flood_reach(seeds: torch.Tensor, mask: torch.Tensor,
                connectivity: int = 8, max_iters: int | None = None,
                leap: int = 1) -> torch.Tensor:
    """All mask pixels 4- or 8-connected to a seed, bool [B,H,W] each;
    with 8-connectivity, mask pixels within Chebyshev distance `leap`
    count as connected.

    8-connected floods are dispatched as the reference dispatches on its
    accelerator: a page that passes `packed_fits` takes the packed flood,
    a larger one the sweep flood on byte planes. The threshold is the
    reference's (what its packed kernel can hold on chip), not a limit of
    this card: both routes take any page here and give the same exact
    result.

    4-connected floods run the reference's fixed point in plain torch on
    either device. The reference runs no kernel there either, so this is
    the port's counterpart, not a fallback. Its multigrid level (a flood of
    the 4 x 4-coarsened page whose result seeds the full one) only saves
    rounds; the fixed point is the same without it, and it is left out, so
    a finite `max_iters` counts this function's own rounds.

    max_iters=None iterates to the true fixed point (a cap of H*W + 2
    rounds that convergence always beats)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if connectivity == 4 and leap != 1:
        raise ValueError(f"leap={leap} requires 8-connectivity")
    b, h, w = mask.shape
    mask = mask.to(torch.bool)
    seeds = seeds.to(torch.bool)
    if connectivity == 4:
        return _flood4(seeds, mask, max_iters)
    with metrics.span("flood"):
        if not packed_fits(h, w):  # both floods keep the seeds in the mask
            out = flood_sweep(seeds, mask, leap=leap, max_iters=max_iters)
            metrics.count("flood.rounds", fs.last_rounds)
            return out
        out = flood_packed(pack_rows(seeds), pack_rows(mask), h, w,
                           leap=leap, max_iters=max_iters)
        if metrics.tracing():  # a view of the card's count: nothing read
            metrics.count("flood.rounds", fp.last_info[3:4])
        return unpack_rows(out, h)


def label_components(mask: torch.Tensor, connectivity: int = 8,
                     max_iters: int | None = None) -> torch.Tensor:
    """Component labels of a bool [B,H,W] plane: int32 [B,H,W], the least
    flat index y*W + x of the pixel's 4- or 8-connected component, H*W on
    the background. max_iters caps the plain version's rounds only."""
    mask = mask.to(torch.bool)
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    links = None if connectivity == 8 else mask_links(mask, 4)
    return label_links(mask, links, max_iters)


def label_components_links(valid: torch.Tensor, links: dict,
                           max_iters: int | None = None) -> torch.Tensor:
    """Component labels under pairwise links (SWT's components of similar
    stroke width). valid: bool [B,H,W]; links: {(dy,dx): bool [B,H,W]}
    over (0,1),(1,0),(1,1),(1,-1), links[d][b,y,x] joining (y,x) to
    (y+dy,x+dx). int32 labels as in `label_components`."""
    return label_links(valid.to(torch.bool), links, max_iters)


def small_cluster_mask(mask: torch.Tensor, k: int,
                       connectivity: int = 8) -> torch.Tensor:
    """Pixels whose 8-connected cluster has <= k members, bool [B,H,W].
    Exact for every k, dispatched as the reference dispatches on its
    accelerator:

    * k = 1: the direct ball count (kernel `noise_ball`);
    * 2 <= k <= 15: the certificate sweep plus the packed flood;
    * k >= 16: the bitboard formulation in plain torch, as the reference
      computes it in XLA outside any Pallas kernel.
    k <= 0 erases nothing."""
    if connectivity != 8:
        raise ValueError("noisefilter clusters are 8-connected")
    mask = mask.to(torch.bool)
    if k < 1:
        return torch.zeros_like(mask)
    if k == 1:
        return noise_ball(mask, 1)
    if k <= 15:
        return small_cluster_mask_cert(mask, k)
    return small_cluster_mask_bitboard(mask, k)


def small_cluster_mask_bitboard(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's XLA formulation (`morph.small_cluster_mask`, the
    path past the Pallas kernels): each pixel carries a (2k+1)^2-bit board
    of the window offsets reachable within j steps through the mask; after
    k dilation steps |ball| <= k iff the cluster has <= k pixels.

    The board spans ceil((2k+1)^2/32) int32 planes (35 at k = 16), and a
    shift by (ey, ex) moves it by ey*(2k+1)+ex bits, which may cross more
    than a word. The reference runs no kernel here: this plain version is
    the port's counterpart on either device, not a fallback."""
    b, h, w = mask.shape
    s = 2 * k + 1
    nb = s * s
    nw = (nb + 31) // 32
    dev = mask.device
    mp = F.pad(mask.to(torch.int32), (k, k, k, k))
    m_words = [torch.zeros((b, h, w), dtype=torch.int32, device=dev)
               for _ in range(nw)]
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            wi, o = divmod((dy + k) * s + (dx + k), 32)
            m_words[wi] |= mp[:, k + dy: k + dy + h, k + dx: k + dx + w] << o

    def valid_word(ex: int, wi: int) -> int:
        """Bits of word wi that stay inside the window after a shift of
        ex columns (the rest aliased a neighbouring window row)."""
        v = 0
        for bit in range(32):
            bb = wi * 32 + bit
            if bb < nb and -k <= bb % s - k - ex <= k:
                v |= 1 << bit
        return _i32(v)

    dirs = [(ey, ex) for ey in (-1, 0, 1) for ex in (-1, 0, 1)
            if (ey, ex) != (0, 0)]
    valid = {d: [valid_word(d[1], wi) for wi in range(nw)] for d in dirs}
    zero = torch.zeros((b, h, w), dtype=torch.int32, device=dev)

    def bit_shift(words, amt):
        """The nb-bit board shifted by amt bits, zero fill: a whole-word
        offset plus a sub-word bit offset."""
        wo, bo = divmod(abs(amt), 32)
        out = []
        for wi in range(nw):
            src, carry = (wi - wo, wi - wo - 1) if amt > 0 else (
                wi + wo, wi + wo + 1)
            v = zero
            if 0 <= src < nw:
                v = words[src] if bo == 0 else (
                    words[src] << bo if amt > 0 else lsr(words[src], bo))
            if bo and 0 <= carry < nw:
                v = v | (lsr(words[carry], 32 - bo) if amt > 0
                         else words[carry] << (32 - bo))
            out.append(v)
        return out

    cw, co = divmod(k * s + k, 32)
    r = [torch.where(mask, _i32(1 << co), 0).to(torch.int32) if wi == cw
         else zero for wi in range(nw)]
    for _ in range(k):
        acc = list(r)
        for d in dirs:
            shifted = bit_shift(r, d[0] * s + d[1])
            for wi in range(nw):
                acc[wi] = acc[wi] | (shifted[wi] & valid[d][wi])
        r = [acc[wi] & m_words[wi] for wi in range(nw)]
    size = sum(_popcount(x) for x in r)
    return mask & (size <= k)
