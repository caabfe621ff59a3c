"""Flood fill and small-cluster mask (port of the subset of
`libpillowfight_tpu/ops/morph.py` the cleanup chain uses).

Both run on bit-packed planes through the wrappers of `ops/cuda`: the
hand-written kernels for CUDA tensors, their plain PyTorch versions for
CPU tensors. The flood is an exact fixed point, so its result does not
depend on the round structure, only on the connectivity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda.flood_packed import flood_packed, pack_rows, unpack_rows
from .cuda.noise import small_cluster_mask_cert


def dilate_cheb(x: torch.Tensor, k: int) -> torch.Tensor:
    """Chebyshev-ball dilation of radius k of a bool [B,H,W] plane."""
    y = F.max_pool2d(x.to(torch.float32)[:, None], 2 * k + 1, stride=1,
                     padding=k)
    return y[:, 0] > 0


def flood_reach(seeds: torch.Tensor, mask: torch.Tensor,
                connectivity: int = 8, max_iters: int | None = None,
                leap: int = 1) -> torch.Tensor:
    """All mask pixels 8-connected to a seed, bool [B,H,W] each; mask
    pixels within Chebyshev distance `leap` count as connected.

    max_iters=None iterates to the true fixed point (a cap of H*W + 2
    rounds that convergence always beats)."""
    if connectivity != 8:
        raise ValueError(f"connectivity={connectivity}: the port floods "
                         f"8-connected only")
    b, h, w = mask.shape
    mask = mask.to(torch.bool)
    seeds = seeds.to(torch.bool) & mask
    out = flood_packed(pack_rows(seeds), pack_rows(mask), h, w, leap=leap,
                       max_iters=max_iters)
    return unpack_rows(out, h)


def small_cluster_mask(mask: torch.Tensor, k: int,
                       connectivity: int = 8) -> torch.Tensor:
    """Pixels whose 8-connected cluster has <= k members (1 <= k <= 15),
    by the certificate sweep plus the packed flood."""
    if connectivity != 8:
        raise ValueError("noisefilter clusters are 8-connected")
    return small_cluster_mask_cert(mask.to(torch.bool), k)
