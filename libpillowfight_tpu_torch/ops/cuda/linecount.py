"""Row and column dark counts (kernel `csrc/linecount.cu`).

Replaces `libpillowfight_tpu/ops/pallas/linecount_kernel.py` `_lc_kernel`
(via `line_counts_pallas`). Counts are returned as f32 like the
reference; they are exact integers below 2**24.
"""

from __future__ import annotations

import torch

from ... import _build
from . import expect, use_kernel

launches = 0


def line_counts_plain(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows f32 [B,H], cols f32 [B,W]) for a bool [B,H,W] plane."""
    rows = plane.sum(dim=2, dtype=torch.int32).to(torch.float32)
    cols = plane.sum(dim=1, dtype=torch.int32).to(torch.float32)
    return rows, cols


def line_counts_cuda(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    expect(plane, "plane", (torch.bool, torch.uint8), 3)
    b, h, w = plane.shape
    rows = torch.empty((b, h), dtype=torch.float32, device=plane.device)
    cols = torch.zeros((b, w), dtype=torch.int32, device=plane.device)
    lib = _build.load()
    _build.check(lib.pft_line_counts(plane.data_ptr(), rows.data_ptr(),
                                     cols.data_ptr(), b, h, w,
                                     _build.stream_of(plane)),
                 "pft_line_counts")
    launches += 1
    return rows, cols.to(torch.float32)


def line_counts(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if use_kernel(plane):
        return line_counts_cuda(plane)
    return line_counts_plain(plane)
