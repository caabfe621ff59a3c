"""unpaper blackfilter (port of `libpillowfight_tpu/ops/unpaper/blackfilter.py`).

Any scan square whose dark ratio reaches the scan threshold seeds a
flood over the connected dark region (gaps up to `intensity` pixels are
leapt), which is wiped.
"""

from __future__ import annotations

import torch

from ...core import constants as C
from ..morph import flood_reach
from .common import (apply_wipe, block_counts, coverage_from_blocks,
                     dark_mask, f32)


def blackfilter_wipe_dark(dark: torch.Tensor,
                          scan_size: int = C.BLACKFILTER_SCAN_SIZE,
                          scan_step: int = C.BLACKFILTER_SCAN_STEP,
                          scan_threshold: float = C.BLACKFILTER_SCAN_THRESHOLD,
                          intensity: int = C.BLACKFILTER_INTENSITY
                          ) -> torch.Tensor:
    """Decision core on a dark plane (bool [B,H,W])."""
    counts = block_counts(dark, scan_size, scan_step)
    triggered = counts >= f32(scan_threshold * scan_size * scan_size, counts)
    seed_area = coverage_from_blocks(triggered, dark.shape, scan_size,
                                     scan_step)
    return flood_reach(seed_area & dark, dark, connectivity=8,
                       leap=intensity)


def blackfilter_wipe(gray: torch.Tensor,
                     scan_size: int = C.BLACKFILTER_SCAN_SIZE,
                     scan_step: int = C.BLACKFILTER_SCAN_STEP,
                     scan_threshold: float = C.BLACKFILTER_SCAN_THRESHOLD,
                     black_threshold: float = C.UNPAPER_BLACK_THRESHOLD,
                     intensity: int = C.BLACKFILTER_INTENSITY) -> torch.Tensor:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return blackfilter_wipe_dark(dark_mask(gray, black_threshold), scan_size,
                                 scan_step, scan_threshold, intensity)


def unpaper_blackfilter(pages: torch.Tensor, **kwargs) -> torch.Tensor:
    return apply_wipe(pages, blackfilter_wipe, **kwargs)
