"""Gaussian blur (port of `libpillowfight_tpu/ops/gaussian.py`).

A separable 1-D Gaussian on each RGB plane; alpha passes through.
"""

from __future__ import annotations

import torch

from ..core import constants as C
from ..core.bitmap import ensure_batched, maybe_unbatch, to_uint8
from .conv import gaussian_taps
from .cuda.gaussian import gaussian_sep


def _blur_planes(planes: torch.Tensor, sigma: float,
                 nb_stddev: int) -> torch.Tensor:
    """f32 [N,H,W] -> blurred f32 [N,H,W]: the fused kernel for CUDA
    tensors, `conv.sep_conv2d` for CPU tensors."""
    return gaussian_sep(planes, gaussian_taps(sigma, nb_stddev))


def gaussian(pages: torch.Tensor, sigma: float = C.GAUSSIAN_DEFAULT_SIGMA,
             nb_stddev: int = C.GAUSSIAN_DEFAULT_NB_STDDEV) -> torch.Tensor:
    """uint8 RGBA [B,H,W,4] (or one page) -> blurred uint8 RGBA."""
    pages, unb = ensure_batched(pages)
    b, h, w, _ = pages.shape
    planes = pages[..., :3].permute(0, 3, 1, 2).to(torch.float32).contiguous()
    blurred = _blur_planes(planes.reshape(b * 3, h, w), sigma, nb_stddev)
    rgb = to_uint8(blurred.reshape(b, 3, h, w).permute(0, 2, 3, 1))
    return maybe_unbatch(torch.cat([rgb, pages[..., 3:]], dim=-1), unb)


def gaussian_on_matrix(gray: torch.Tensor,
                       sigma: float = C.GAUSSIAN_DEFAULT_SIGMA,
                       nb_stddev: int = C.GAUSSIAN_DEFAULT_NB_STDDEV
                       ) -> torch.Tensor:
    """f32 [B,H,W] -> f32 [B,H,W]; reused by canny."""
    return _blur_planes(gray, sigma, nb_stddev)
