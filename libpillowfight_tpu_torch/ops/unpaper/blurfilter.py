"""unpaper blurfilter (port of `libpillowfight_tpu/ops/unpaper/blurfilter.py`).

Block (i,j) of `size` x `size` at stride `step` is wiped iff 0 < its
non-white ratio <= intensity and the max ratio over its 8 neighbours at
grid offset d = size//step is <= intensity (missing neighbours count as
clean).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import constants as C
from .common import (apply_wipe, block_counts, coverage_from_blocks, f32,
                     nonwhite_mask)


def blurfilter_wipe_nonwhite(mask: torch.Tensor,
                             size: int = C.BLURFILTER_SIZE,
                             step: int = C.BLURFILTER_STEP,
                             intensity: float = C.BLURFILTER_INTENSITY
                             ) -> torch.Tensor:
    """Decision core on a non-white plane (bool [B,H,W])."""
    ratios = block_counts(mask, size, step) / float(size * size)  # f32
    d = max(size // step, 1)
    p = F.pad(ratios, (d, d, d, d))
    nby, nbx = ratios.shape[1], ratios.shape[2]
    neighbor_max = None
    for dy in (-d, 0, d):
        for dx in (-d, 0, d):
            if dy == 0 and dx == 0:
                continue
            n = p[:, d + dy: d + dy + nby, d + dx: d + dx + nbx]
            neighbor_max = n if neighbor_max is None else torch.maximum(
                neighbor_max, n)
    lim = f32(intensity, ratios)
    lonely = (ratios > 0) & (ratios <= lim) & (neighbor_max <= lim)
    return coverage_from_blocks(lonely, mask.shape, size, step) & mask


def blurfilter_wipe(gray: torch.Tensor, size: int = C.BLURFILTER_SIZE,
                    step: int = C.BLURFILTER_STEP,
                    intensity: float = C.BLURFILTER_INTENSITY
                    ) -> torch.Tensor:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return blurfilter_wipe_nonwhite(nonwhite_mask(gray), size, step,
                                    intensity)


def unpaper_blurfilter(pages: torch.Tensor, **kwargs) -> torch.Tensor:
    return apply_wipe(pages, blurfilter_wipe, **kwargs)
