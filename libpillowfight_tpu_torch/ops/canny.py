"""Canny edge detector (port of `libpillowfight_tpu/ops/canny.py`).

gray -> gaussian (sigma 2, 5 stddev) -> sobel gradients -> non-maximum
suppression (direction in 4 bins) -> double threshold (fractions of the
per-page peak) -> hysteresis (weak pixels kept iff 8-connected to a
strong one), by the packed flood of `morph.flood_reach` at leap 1.
Output: edges white (255) on black, gray RGBA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import constants as C
from ..core.bitmap import (ensure_batched, gray_to_rgba, maybe_unbatch,
                           normalize, rgba_to_gray)
from .gaussian import gaussian_on_matrix
from .morph import flood_reach
from .sobel import hypot, sobel_gradients

_T1 = float(np.tan(np.pi / 8))
_T2 = float(np.tan(3 * np.pi / 8))


def _nms(intensity: torch.Tensor, gx: torch.Tensor,
         gy: torch.Tensor) -> torch.Tensor:
    """Non-maximum suppression from the raw gradient pair, f32 [B,H,W],
    without an atan2 plane. With ax = |gx|, ay = |gy|, the half-even bins
    of theta / (pi/4) are: bin 0 (compare W/E) iff ay <= tan(22.5) ax;
    bin 2 (compare N/S) iff ay >= tan(67.5) ax; else diagonal, bin 1
    (NE/SW) when gx*gy > 0 and bin 3 (NW/SE) when < 0."""
    ax, ay = gx.abs(), gy.abs()
    bin0 = ay <= _T1 * ax
    bin2 = ay >= _T2 * ax
    diag_pos = gx * gy > 0.0
    z = F.pad(intensity, (1, 1, 1, 1))
    h, w = intensity.shape[-2:]

    def shift(dy, dx):  # neighbour intensity, zero outside
        return z[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    diag_a = torch.where(diag_pos, shift(-1, 1), shift(-1, -1))
    diag_b = torch.where(diag_pos, shift(1, -1), shift(1, 1))
    a = torch.where(bin0, shift(0, 1), torch.where(bin2, shift(-1, 0), diag_a))
    b = torch.where(bin0, shift(0, -1), torch.where(bin2, shift(1, 0), diag_b))
    keep = (intensity >= a) & (intensity >= b)
    return torch.where(keep, intensity, torch.zeros_like(intensity))


def canny_gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) of the Gaussian-smoothed page: the gradient stack canny
    and SWT share."""
    smoothed = gaussian_on_matrix(gray, C.CANNY_GAUSSIAN_SIGMA,
                                  C.CANNY_GAUSSIAN_NB_STDDEV)
    return sobel_gradients(smoothed)


def canny_intensity(inten: torch.Tensor, lo: torch.Tensor | None = None,
                    hi: torch.Tensor | None = None) -> torch.Tensor:
    """The gradient intensity `hypot(gx, gy)` normalized to [0,255] by
    the page's extrema (`normalize`'s lo, hi) and rounded to the integer
    grid, so that ridge ties break in NMS as in the reference."""
    return torch.round(normalize(inten, lo, hi))


def canny_threshold(nms: torch.Tensor, peak: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(strong, weak) of the double threshold of the suppressed
    intensity, at fractions of the page's peak ([B,1,1]; taken from `nms`
    when not given). The strict `nms > 0` guard leaves a flat page (peak
    0) without edges."""
    if peak is None:
        peak = torch.amax(nms, dim=(-2, -1), keepdim=True)
    live = nms > 0.0
    strong = (nms >= peak * C.CANNY_HIGH_THRESHOLD_FRACTION) & live
    weak = (nms >= peak * C.CANNY_LOW_THRESHOLD_FRACTION) & live
    return strong, weak


def canny_strong_weak(gx: torch.Tensor, gy: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (strong, weak) bool planes of the double threshold, from the
    smoothed gradients of whole pages. A row shard takes the steps one by
    one with its page's extrema and peak (`parallel/spatial_edges.py`)."""
    return canny_threshold(_nms(canny_intensity(hypot(gx, gy)), gx, gy))


def canny_edge_mask_from_gradients(gx: torch.Tensor,
                                   gy: torch.Tensor) -> torch.Tensor:
    """bool edge mask from smoothed gradients: the weak pixels
    8-connected to a strong one (hysteresis)."""
    strong, weak = canny_strong_weak(gx, gy)
    return flood_reach(strong, weak, connectivity=8)


def canny_edge_mask(gray: torch.Tensor) -> torch.Tensor:
    """f32 gray [B,H,W] -> bool edge mask [B,H,W]."""
    return canny_edge_mask_from_gradients(*canny_gradients(gray))


def canny(pages: torch.Tensor) -> torch.Tensor:
    """uint8 RGBA [B,H,W,4] -> edge page (white edges on black)."""
    pages, unb = ensure_batched(pages)
    edges = canny_edge_mask(rgba_to_gray(pages))
    return maybe_unbatch(gray_to_rgba(edges.to(torch.float32) * 255.0), unb)
