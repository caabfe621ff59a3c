"""Row and column dark counts (kernel `csrc/linecount.cu`).

Replaces `libpillowfight_tpu/ops/pallas/linecount_kernel.py` `_lc_kernel`
(via `line_counts_pallas`). Counts are returned as f32 like the
reference; they are exact integers below 2**24. A uint8 plane counts its
non-zero bytes, as a bool plane counts its True pixels, in both versions.
"""

from __future__ import annotations

import torch

from ... import _build
from . import expect, use_kernel

launches = 0

MAX_SIDE = 1 << 24     # every count stays an exact f32 integer
BAND_ROWS = 128        # rows a block: the grid's second dimension
GRID_LIMIT = 65535     # of the grid's second and third dimensions


def line_counts_plain(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows f32 [B,H], cols f32 [B,W]): the non-zero pixels of each row
    and column of a bool or uint8 [B,H,W] plane."""
    if plane.dtype != torch.bool:
        plane = plane != 0
    rows = plane.sum(dim=2, dtype=torch.int32).to(torch.float32)
    cols = plane.sum(dim=1, dtype=torch.int32).to(torch.float32)
    return rows, cols


def line_counts_cuda(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    expect(plane, "plane", (torch.bool, torch.uint8), 3)
    b, h, w = plane.shape
    if b > GRID_LIMIT or h > GRID_LIMIT * BAND_ROWS or w >= MAX_SIDE:
        raise ValueError(f"plane {tuple(plane.shape)}: the kernel takes "
                         f"B <= {GRID_LIMIT}, H <= {GRID_LIMIT * BAND_ROWS}"
                         f" and W < {MAX_SIDE}")
    out = torch.empty(b * h + b * w, dtype=torch.float32, device=plane.device)
    _build.launch("pft_line_counts", plane, plane.data_ptr(), out.data_ptr(),
                  b, h, w)
    launches += 1
    return out[:b * h].view(b, h), out[b * h:].view(b, w)


def line_counts(plane: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if use_kernel(plane):
        return line_counts_cuda(plane)
    return line_counts_plain(plane)
