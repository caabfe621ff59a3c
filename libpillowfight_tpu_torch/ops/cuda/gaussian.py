"""Fused separable blur (kernel `csrc/gaussian_sep.cu`).

Replaces `libpillowfight_tpu/ops/pallas/gaussian_kernel.py` `_blur_kernel`
(via `gaussian_sep_pallas`). The plain version is `ops/conv.py`
`sep_conv2d`; the kernel sums in its order, so the two agree bit for bit.

The kernel has two instances: one built for 21 taps (every path's: sigma
2 at 5 stddev), taken when none of the 21 f32 taps is 0 or 1, and a
generic one for any odd count up to `MAX_TAPS`, which skips a tap of 0
and does not multiply by a tap of 1, as the plain version does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import _build
from ..conv import sep_conv2d
from . import expect, use_kernel

launches = 0
instance_launches = {"hw10": 0, "generic": 0}

MAX_TAPS = 97  # the generic instance's shared-memory tile holds <= 48 px
HW10_TAPS = 21


def gaussian_sep_plain(planes: torch.Tensor, taps) -> torch.Tensor:
    """f32 [N,H,W] correlated with taps along W, then along H, zero
    padding."""
    k = np.asarray(taps, np.float32)
    return sep_conv2d(planes, k[::-1])  # sep_conv2d flips: correlate


def kernel_instance(taps) -> str:
    """"hw10" or "generic": the instance the kernel's C entry picks for
    these taps (it reports its pick, which fills `instance_launches`)."""
    k = np.asarray(taps, np.float32)
    if len(k) == HW10_TAPS and not np.any((k == 0) | (k == 1)):
        return "hw10"
    return "generic"


def gaussian_sep_cuda(planes: torch.Tensor, taps) -> torch.Tensor:
    global launches
    expect(planes, "planes", (torch.float32,), 3)
    n_taps = len(taps)
    if n_taps % 2 == 0 or not 1 <= n_taps <= MAX_TAPS:
        raise ValueError(f"{n_taps} taps: the kernel takes an odd count "
                         f"up to {MAX_TAPS}")
    n, h, w = planes.shape
    out = torch.empty_like(planes)
    instance = ctypes.c_int()
    _build.launch("pft_gaussian_sep", planes, planes.data_ptr(),
                  out.data_ptr(), (ctypes.c_float * n_taps)(*taps), n_taps,
                  n, h, w, ctypes.byref(instance))
    launches += 1
    instance_launches["hw10" if instance.value else "generic"] += 1
    return out


def gaussian_sep(planes: torch.Tensor, taps) -> torch.Tensor:
    if use_kernel(planes):
        return gaussian_sep_cuda(planes, taps)
    return gaussian_sep_plain(planes, taps)
