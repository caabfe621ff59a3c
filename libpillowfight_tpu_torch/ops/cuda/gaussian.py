"""Fused separable blur (kernel `csrc/gaussian_sep.cu`).

Replaces `libpillowfight_tpu/ops/pallas/gaussian_kernel.py` `_blur_kernel`
(via `gaussian_sep_pallas`). The plain version is `ops/conv.py`
`sep_conv2d`; the kernel sums in its order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from ..conv import sep_conv2d
from . import expect, use_kernel

launches = 0

MAX_TAPS = 97  # the kernel's shared-memory tile holds a halo of <= 48 px


def gaussian_sep_plain(planes: torch.Tensor, taps) -> torch.Tensor:
    """f32 [N,H,W] correlated with taps along W, then along H, zero
    padding."""
    k = np.asarray(taps, np.float32)
    return sep_conv2d(planes, k[::-1])  # sep_conv2d flips: correlate


def gaussian_sep_cuda(planes: torch.Tensor, taps) -> torch.Tensor:
    expect(planes, "planes", (torch.float32,), 3)
    n_taps = len(taps)
    if n_taps % 2 == 0 or not 1 <= n_taps <= MAX_TAPS:
        raise ValueError(f"{n_taps} taps: the kernel takes an odd count "
                         f"up to {MAX_TAPS}")
    n, h, w = planes.shape
    if n > 65535:
        raise ValueError(f"{n} planes: the kernel's grid takes <= 65535")
    out = torch.empty_like(planes)
    host_taps = (ctypes.c_float * n_taps)(*np.asarray(taps, np.float32))
    _build.check(_build.load().pft_gaussian_sep(
        planes.data_ptr(), out.data_ptr(), host_taps, n_taps, n, h, w,
        _build.stream_of(planes)), "pft_gaussian_sep")
    global launches
    launches += 1
    return out


def gaussian_sep(planes: torch.Tensor, taps) -> torch.Tensor:
    if use_kernel(planes):
        return gaussian_sep_cuda(planes, taps)
    return gaussian_sep_plain(planes, taps)
