"""Sobel edge detector (port of `libpillowfight_tpu/ops/sobel.py`).

gray -> 3x3 Gx/Gy correlation -> intensity hypot(gx, gy) and direction
atan2(gy, gx). The public op returns the intensity clipped to [0,255] as
a gray RGBA page. The reference computes sobel outside any Pallas kernel,
and so does the port: plain torch on either device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.bitmap import ensure_batched, gray_to_rgba, maybe_unbatch, rgba_to_gray
from .conv import SOBEL_GX, SOBEL_GY, correlate2d


class GradientMatrixes(NamedTuple):
    intensity: torch.Tensor  # f32 [B,H,W]
    direction: torch.Tensor  # f32 [B,H,W], atan2(gy, gx) in [-pi, pi]


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) in the reference's form (jnp.hypot): the larger
    leg times sqrt(1 + r^2), r the ratio of the legs. IEEE division and
    square root round alike on both devices, where the devices' own
    hypot functions need not."""
    x, y = x.abs(), y.abs()
    big, small = torch.maximum(x, y), torch.minimum(x, y)
    zero = big == 0
    r = small / torch.where(zero, torch.ones_like(big), big)
    out = torch.where(zero, big, big * torch.sqrt(1 + r * r))
    return torch.where(torch.isposinf(x) | torch.isposinf(y),
                       torch.full_like(out, float("inf")), out)


def sobel_gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw (gx, gy); correlation, so the gradient points from dark to
    light."""
    return correlate2d(gray, SOBEL_GX), correlate2d(gray, SOBEL_GY)


def sobel_on_matrix(gray: torch.Tensor) -> GradientMatrixes:
    gx, gy = sobel_gradients(gray)
    return GradientMatrixes(hypot(gx, gy), torch.atan2(gy, gx))


def sobel(pages: torch.Tensor) -> torch.Tensor:
    """uint8 RGBA [B,H,W,4] -> edge-intensity gray RGBA [B,H,W,4]."""
    pages, unb = ensure_batched(pages)
    gx, gy = sobel_gradients(rgba_to_gray(pages))
    return maybe_unbatch(gray_to_rgba(torch.clamp(hypot(gx, gy), 0.0, 255.0)),
                         unb)
