"""unpaper masks (port of `libpillowfight_tpu/ops/unpaper/masks.py`).

From each start point (default: the page centre) a scan strip of width
`size` slides outward at stride `step` in the four directions; the mask
edge is the first strip whose dark ratio falls below `threshold`.
Everything outside the union of the mask rectangles is wiped.
"""

from __future__ import annotations

import torch

from ...core import constants as C
from .common import apply_wipe, dark_mask, f32, line_counts


def _mask_edge(counts: torch.Tensor, perp_extent: int, center: int,
               size: int, step: int, threshold: float,
               outward_is_down: bool) -> torch.Tensor:
    """First blank strip scanning outward from `center` in counts f32
    [B,N]: its start (toward 0) or its end (toward N); no blank strip ->
    0 (resp. N). Strips that fall off the page are never blank."""
    n = counts.shape[1]
    cs = torch.cat([torch.zeros_like(counts[:, :1]),
                    torch.cumsum(counts, dim=1)], dim=1)  # exact below 2**24
    if outward_is_down:
        k_max = max((center - size) // step + 1, 1)
        starts = center - size - torch.arange(k_max, device=counts.device) * step
    else:
        k_max = max((n - center - size) // step + 1, 1)
        starts = center + torch.arange(k_max, device=counts.device) * step
    in_range = (starts >= 0) & (starts + size <= n)
    safe = torch.clamp(starts, 0, max(n - size, 0))
    strip = cs[:, safe + size] - cs[:, safe]  # [B, K]
    blank = (strip < f32(threshold * size * perp_extent, strip)) & in_range
    first = torch.argmax(blank.to(torch.int32), dim=1)  # first max
    if outward_is_down:
        return torch.where(blank.any(dim=1), starts[first], 0)
    return torch.where(blank.any(dim=1), starts[first] + size, n)


def masks_wipe_dark(dark: torch.Tensor,
                    scan_size: int = C.MASKS_SCAN_SIZE,
                    scan_step: int = C.MASKS_SCAN_STEP,
                    scan_threshold: float = C.MASKS_SCAN_THRESHOLD,
                    starts: tuple | None = None) -> torch.Tensor:
    """Decision core on a dark plane (bool [B,H,W]). starts: (y, x)
    start points; None is the single page-centre point."""
    b, h, w = dark.shape
    if starts is None:
        starts = ((h // 2, w // 2),)
    rows, cols = line_counts(dark)
    ys = torch.arange(h, device=dark.device).view(1, h, 1)
    xs = torch.arange(w, device=dark.device).view(1, 1, w)
    args = (scan_size, scan_step, scan_threshold)
    keep = None
    for sy, sx in starts:
        sy, sx = int(sy), int(sx)
        left = _mask_edge(cols, h, sx, *args, True)[:, None, None]
        right = _mask_edge(cols, h, sx, *args, False)[:, None, None]
        top = _mask_edge(rows, w, sy, *args, True)[:, None, None]
        bottom = _mask_edge(rows, w, sy, *args, False)[:, None, None]
        rect = (((xs >= left) & (xs < right))
                & ((ys >= top) & (ys < bottom)))
        keep = rect if keep is None else keep | rect
    return ~keep


def masks_wipe(gray: torch.Tensor, scan_size: int = C.MASKS_SCAN_SIZE,
               scan_step: int = C.MASKS_SCAN_STEP,
               scan_threshold: float = C.MASKS_SCAN_THRESHOLD,
               starts: tuple | None = None) -> torch.Tensor:
    """Wipe mask from a gray plane f32 [B,H,W]."""
    return masks_wipe_dark(dark_mask(gray), scan_size, scan_step,
                           scan_threshold, starts)


def unpaper_masks(pages: torch.Tensor, **kwargs) -> torch.Tensor:
    return apply_wipe(pages, masks_wipe, **kwargs)
