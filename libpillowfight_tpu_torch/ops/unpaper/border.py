"""unpaper border (port of `libpillowfight_tpu/ops/unpaper/border.py`).

Scans inward from each page edge in strips of `size` rows/columns at
stride `step`; the border ends at the first strip whose dark count
exceeds `threshold`, and the border area is wiped. Scan depth is capped
at half the page.
"""

from __future__ import annotations

import torch

from ...core import constants as C
from .common import apply_wipe, dark_mask, f32, line_counts


def _border_extent(counts: torch.Tensor, extent: int, size: int, step: int,
                   threshold: float, from_end: bool) -> torch.Tensor:
    """counts f32 [B,N] -> int32 [B]: border pixels from the chosen edge."""
    if from_end:
        counts = torch.flip(counts, dims=(1,))
    cs = torch.cat([torch.zeros_like(counts[:, :1]),
                    torch.cumsum(counts, dim=1)], dim=1)  # exact below 2**24
    k_max = max((extent // 2 - size) // step + 1, 1)
    starts = torch.arange(k_max, device=counts.device) * step
    strip = cs[:, starts + size] - cs[:, starts]          # [B, K]
    has_content = strip > f32(threshold, strip)
    first = torch.argmax(has_content.to(torch.int32), dim=1)  # first max
    first = torch.where(has_content.any(dim=1), first, k_max)
    return (first * step).to(torch.int32)


def border_wipe_dark(dark: torch.Tensor,
                     scan_size: int = C.BORDER_SCAN_SIZE,
                     scan_step: int = C.BORDER_SCAN_STEP,
                     scan_threshold: float = C.BORDER_SCAN_THRESHOLD
                     ) -> torch.Tensor:
    """Decision core on a dark plane (bool [B,H,W])."""
    b, h, w = dark.shape
    rows, cols = line_counts(dark)
    args = (scan_size, scan_step, scan_threshold)
    top = _border_extent(rows, h, *args, False)[:, None, None]
    bottom = _border_extent(rows, h, *args, True)[:, None, None]
    left = _border_extent(cols, w, *args, False)[:, None, None]
    right = _border_extent(cols, w, *args, True)[:, None, None]
    ys = torch.arange(h, device=dark.device).view(1, h, 1)
    xs = torch.arange(w, device=dark.device).view(1, 1, w)
    return ((ys < top) | (ys >= h - bottom)) | ((xs < left) | (xs >= w - right))


def border_wipe(gray: torch.Tensor, scan_size: int = C.BORDER_SCAN_SIZE,
                scan_step: int = C.BORDER_SCAN_STEP,
                scan_threshold: float = C.BORDER_SCAN_THRESHOLD
                ) -> torch.Tensor:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return border_wipe_dark(dark_mask(gray), scan_size, scan_step,
                            scan_threshold)


def unpaper_border(pages: torch.Tensor, **kwargs) -> torch.Tensor:
    return apply_wipe(pages, border_wipe, **kwargs)
