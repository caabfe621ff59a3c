"""Convolution primitives of the gradient stack (port of
`libpillowfight_tpu/ops/conv.py`).

Zero padding, output the size of the input, true convolution (kernel
flipped) for `conv2d`, correlation for `correlate2d`. Every filter is an
unrolled chain of shifted multiply-adds in row-major tap order, zero
taps skipped and the first term as the start value: the reference's CPU
path (`_conv_shifts`), so the sums round in the same order.
`F.conv2d` is not used: on a CUDA card cuDNN runs float32 convolutions
in TF32 by default, and its order of summation is its own.

This module is the plain version of the blur kernel
(`ops/cuda/gaussian.py`) and sobel's only form: the reference computes
sobel outside any Pallas kernel too.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], zero outside."""
    h, w = x.shape[-2:]
    py, px = abs(dy), abs(dx)
    p = F.pad(x, (px, px, py, py))
    return p[..., py + dy: py + dy + h, px + dx: px + dx + w]


def _conv_shifts(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlation of f32 [..., H, W] with kernel [kh, kw] (taps cast to
    f32, as the reference multiplies by `x.dtype.type(c)`)."""
    kh, kw = kernel.shape
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(kernel[i, j])
            if c == 0.0:
                continue
            term = _shift2(x, i - kh // 2, j - kw // 2)
            if c != 1.0:
                term = term * float(np.float32(c))
            out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(x)


def conv2d(x: torch.Tensor, kernel) -> torch.Tensor:
    """f32 [B,H,W] (*) kernel [kh,kw]: zero-padded same-size true
    convolution."""
    return _conv_shifts(x, np.flip(np.asarray(kernel), (0, 1)))


def correlate2d(x: torch.Tensor, kernel) -> torch.Tensor:
    """Cross-correlation: out[p] = sum_k x[p + k] * kernel[k]."""
    return _conv_shifts(x, np.asarray(kernel))


def sep_conv2d(x: torch.Tensor, k1d) -> torch.Tensor:
    """Separable filter: rows (along W) then columns (along H) with the
    same 1-D kernel."""
    k = np.asarray(k1d)
    return conv2d(conv2d(x, k[None, :]), k[:, None])


def gaussian_taps(sigma: float, nb_stddev: int) -> tuple:
    """1-D Gaussian taps in float64, half-width ceil(sigma*nb_stddev),
    sum-normalized (the blur kernel casts them to float32)."""
    hw = int(np.ceil(float(sigma) * int(nb_stddev)))
    xs = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * float(sigma) ** 2))
    return tuple(float(t) for t in k / k.sum())


def gaussian_kernel_1d(sigma: float, nb_stddev: int) -> np.ndarray:
    """`gaussian_taps` cast to float32."""
    return np.asarray(gaussian_taps(sigma, nb_stddev), np.float32)


SOBEL_GX = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                    np.float32)
SOBEL_GY = SOBEL_GX.T.copy()
