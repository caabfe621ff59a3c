"""Wrappers of the hand-written CUDA kernels (`csrc/`), each beside its
plain PyTorch version.

A wrapper takes the plain version for a tensor on the CPU only. For a
CUDA tensor it launches its kernel or raises; nothing falls back.
"""

from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises for a mix
    or for any other device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel and no plain path for device {dev}")


def expect(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Wrapper-side checks a kernel relies on."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: on {t.device}; the kernel takes CUDA "
                         f"tensors only")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
