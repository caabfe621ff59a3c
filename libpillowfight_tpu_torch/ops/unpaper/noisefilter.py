"""unpaper noisefilter (port of `libpillowfight_tpu/ops/unpaper/noisefilter.py`).

Every 8-connected cluster of at most `intensity` non-white pixels is
wiped.
"""

from __future__ import annotations

import torch

from ...core import constants as C
from ..morph import small_cluster_mask
from .common import apply_wipe, nonwhite_mask


def noisefilter_wipe_nonwhite(nonwhite: torch.Tensor,
                              intensity: int = C.NOISEFILTER_INTENSITY
                              ) -> torch.Tensor:
    """Decision core on a non-white plane (bool [B,H,W])."""
    return small_cluster_mask(nonwhite, intensity, connectivity=8)


def noisefilter_wipe(gray: torch.Tensor,
                     intensity: int = C.NOISEFILTER_INTENSITY) -> torch.Tensor:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return noisefilter_wipe_nonwhite(nonwhite_mask(gray), intensity)


def unpaper_noisefilter(pages: torch.Tensor, **kwargs) -> torch.Tensor:
    return apply_wipe(pages, noisefilter_wipe, **kwargs)
