"""Exact flood on byte planes by directional sweeps (kernel in
`csrc/flood_sweep.cu`).

Replaces `libpillowfight_tpu/ops/pallas/flood_kernel.py`
`_flood_sweep_kernel` (`_flood_sweep`, `flood_reach_pallas`): the route
`morph.flood_reach` takes for pages the packed flood's size test turns
away. bool [B,H,W] in and out, no packing and no padding.

The result is the set of mask pixels connected to a seed, where mask
pixels within Chebyshev distance `leap` count as connected: a unique
fixed point, so the kernel's sweeps and the plain version's rounds agree
bit for bit.
"""

from __future__ import annotations

import torch

from ... import _build
from ...core.bitmap import shift2d
from ...utils.metrics import span
from . import expect, use_kernel

MAX_LEAP = 384  # 1024 threads a block less a halo of `leap` on each side

launches = 0  # launches of the kernel (each a sweep down and a sweep up)
# rounds of the last flood: the kernel's launches, or the plain version's
# rounds, the final one that adds nothing included
last_rounds = 0


def _args(seeds, mask, leap, max_iters) -> tuple:
    if seeds.shape != mask.shape or mask.ndim != 3:
        raise ValueError(f"seeds {tuple(seeds.shape)} vs mask "
                         f"{tuple(mask.shape)}: both must be [B,H,W]")
    if leap < 1:
        raise ValueError(f"leap must be >= 1, got {leap}")
    b, h, w = mask.shape
    leap = min(leap, max(h, w))  # a longer leap reaches nothing more
    return leap, (h * w + 2 if max_iters is None else max_iters)


def _seg_or(mask: torch.Tensor, r: torch.Tensor, dim: int) -> torch.Tensor:
    """r | (any r in the same run of mask along dim), both ways: a pixel
    is reached iff the nearest seed on one side lies past no gap."""
    n = mask.shape[dim]
    shape = [1] * mask.ndim
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    seed = r & mask
    out = seed
    for flip in (False, True):
        m, s = (mask.flip(dim), seed.flip(dim)) if flip else (mask, seed)
        last_seed = torch.cummax(torch.where(s, idx, -1), dim=dim).values
        last_gap = torch.cummax(torch.where(m, -1, idx), dim=dim).values
        hit = m & (last_seed > last_gap)
        out = out | (hit.flip(dim) if flip else hit)
    return out


def _dilate(r: torch.Tensor, k: int) -> torch.Tensor:
    """Chebyshev-ball dilation of radius k of a bool [B,H,W] plane, by
    doubling shifts along each axis."""
    for dy, dx in ((0, 1), (1, 0)):
        c = 0
        while c < k:
            s = min(c + 1, k - c)
            r = (r | shift2d(r, s * dy, s * dx, False)
                 | shift2d(r, -s * dy, -s * dx, False))
            c += s
    return r


def flood_sweep_plain(seeds: torch.Tensor, mask: torch.Tensor, leap: int = 1,
                      max_iters: int | None = None) -> torch.Tensor:
    """The reference's round on byte planes in plain torch (segmented OR
    along rows, along columns, dilation of radius `leap` gated by the
    mask), until a round changes nothing or max_iters rounds have run."""
    global last_rounds
    leap, max_iters = _args(seeds, mask, leap, max_iters)
    mask = mask.to(torch.bool)
    r = seeds.to(torch.bool) & mask
    last_rounds = 0
    for _ in range(max_iters):
        last_rounds += 1
        new = _seg_or(mask, r, 2)
        new = _seg_or(mask, new, 1)
        new = (_dilate(new, leap) & mask) | new
        if torch.equal(new, r):
            break
        r = new
    return r


def _threads(leap: int) -> int:
    """Columns of a block's strip, halo included: narrow strips while the
    halo of `leap` on each side leaves at least half of them its own."""
    for threads in (128, 256, 512):
        if 4 * leap <= threads:
            return threads
    return 1024


def sweep_cuda(mask: torch.Tensor, reach: torch.Tensor,
               changed: torch.Tensor, leap: int) -> None:
    """One kernel launch, a sweep down and a sweep up: grows `reach` in
    place and adds the number of pixels it reached to `changed` (int64
    [1])."""
    expect(mask, "mask", (torch.bool, torch.uint8), 3)
    expect(reach, "reach", (torch.bool, torch.uint8), 3)
    expect(changed, "changed", (torch.int64,), 1)
    if mask.shape != reach.shape:
        raise ValueError(f"mask {tuple(mask.shape)} vs reach "
                         f"{tuple(reach.shape)}")
    if not 1 <= leap <= MAX_LEAP:
        raise ValueError(f"leap={leap}: the sweep kernel takes 1 <= leap "
                         f"<= {MAX_LEAP}")
    b, h, w = mask.shape
    if b > 65535:
        raise ValueError(f"batch {b}: at most 65535 pages")
    _build.launch("pft_flood_sweep", mask, mask.data_ptr(), reach.data_ptr(),
                  changed.data_ptr(), b, h, w, leap, _threads(leap))
    global launches
    launches += 1


def flood_sweep_cuda(seeds: torch.Tensor, mask: torch.Tensor, leap: int = 1,
                     max_iters: int | None = None) -> torch.Tensor:
    """Launches of a down and an up sweep each until one adds nothing; at
    most max_iters launches. The host reads one count a launch.

    The reference stops at the first sweep that adds nothing, which its
    ordered bands allow. Here the strips of one launch do not wait for
    each other, so the proof takes a whole launch that adds nothing: it
    has read only final values, in both directions (`flood_sweep.cu`)."""
    leap, max_iters = _args(seeds, mask, leap, max_iters)
    # no copy where the caller's planes are contiguous bool already; the
    # AND makes the plane the kernel grows in place
    mask = mask.to(torch.bool).contiguous()
    reach = seeds.to(torch.bool) & mask
    changed = torch.zeros(1, dtype=torch.int64, device=mask.device)
    global last_rounds
    total = last_rounds = 0
    for _ in range(max_iters):
        sweep_cuda(mask, reach, changed, leap)
        last_rounds += 1
        with span("sync.flood_sweep"):
            now = int(changed)  # the launch's one read on the host
        if now == total:
            break
        total = now
    return reach


def flood_sweep(seeds: torch.Tensor, mask: torch.Tensor, leap: int = 1,
                max_iters: int | None = None) -> torch.Tensor:
    """Exact reach of the seeds through the mask, bool [B,H,W]."""
    if use_kernel(seeds, mask):
        return flood_sweep_cuda(seeds, mask, leap, max_iters)
    return flood_sweep_plain(seeds, mask, leap, max_iters)
