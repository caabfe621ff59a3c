"""unpaper grayfilter (port of `libpillowfight_tpu/ops/unpaper/grayfilter.py`).

Block `size` x `size` at stride `step` is wiped iff it holds no dark
pixel and its mean gray > 255*(1 - threshold), tested on exact integer
sums of s3 = r+g+b: sum(s3) > 765*(1-t)*size^2.
"""

from __future__ import annotations

import torch

from ...core import constants as C
from .common import (apply_wipe, block_counts, block_sums_u16,
                     coverage_from_blocks, dark_mask, f32)


def grayfilter_wipe_planes_s3(dark: torch.Tensor, s3: torch.Tensor,
                              size: int = C.GRAYFILTER_SIZE,
                              step: int = C.GRAYFILTER_STEP,
                              threshold: float = C.GRAYFILTER_THRESHOLD
                              ) -> torch.Tensor:
    """Decision core on a dark plane (bool) and integer s3 values."""
    dark_counts = block_counts(dark, size, step)
    s3_sums = block_sums_u16(s3, size, step)
    bound = f32(765.0 * (1.0 - threshold) * float(size * size), s3_sums)
    wipe_blocks = (dark_counts == 0) & (s3_sums > bound)
    return coverage_from_blocks(wipe_blocks, dark.shape, size, step)


def grayfilter_wipe_planes(dark: torch.Tensor, gray: torch.Tensor,
                           size: int = C.GRAYFILTER_SIZE,
                           step: int = C.GRAYFILTER_STEP,
                           threshold: float = C.GRAYFILTER_THRESHOLD
                           ) -> torch.Tensor:
    """Shim for f32 gray planes: gray = k/3, so round(3*gray) is the
    exact integer s3."""
    s3 = torch.round(gray * 3.0).to(torch.int32)
    return grayfilter_wipe_planes_s3(dark, s3, size, step, threshold)


def grayfilter_wipe(gray: torch.Tensor, size: int = C.GRAYFILTER_SIZE,
                    step: int = C.GRAYFILTER_STEP,
                    threshold: float = C.GRAYFILTER_THRESHOLD
                    ) -> torch.Tensor:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return grayfilter_wipe_planes(dark_mask(gray), gray, size, step,
                                  threshold)


def unpaper_grayfilter(pages: torch.Tensor, **kwargs) -> torch.Tensor:
    return apply_wipe(pages, grayfilter_wipe, **kwargs)
