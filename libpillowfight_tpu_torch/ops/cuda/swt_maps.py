"""SWT's width maps by line scans (kernels `csrc/swt_maps.cu`).

Computes what `ops/swt.py` computes with `_quantize_angles`,
`_width_pass`, `_ray_medians` and `_median_pass`, bit for bit: both
polarities' stroke-width maps and each page's number of anchors, from
the edges and the angles of the unit gradients (`_gradient_angles`, in
torch). Replaces no TPU kernel: the JAX package leaves its width maps to
XLA plane passes (the source's note says why a kernel was added here and
what bounds it). The plain version is those functions of `ops/swt.py`,
which `_swt_maps_one` takes for CPU tensors; for CUDA tensors it takes
this wrapper, which launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from . import expect, use_kernel  # noqa: F401  (use_kernel: the dispatch)

launches = 0

NDIR = 16
MAX_PAGES = 65535       # the grid's second dimension
MAX_PAGE_PIXELS = 2**31 - 1 - 256  # a page's pixels index as int


def swt_maps_cuda(angles: torch.Tensor, edges: torch.Tensor,
                  table: list[int], floats: list[float]):
    """(swt_minus, swt_plus, n_anchors): f32 [B,H,W] maps (1e9 where no
    stroke) and int32 [B] from the gradients' angles f32 [B,H,W], the
    edges bool [B,H,W] and `ops/swt.py` `_direction_table(max_len)`."""
    global launches
    expect(angles, "angles", (torch.float32,), 3)
    expect(edges, "edges", (torch.bool,), 3)
    if angles.shape != edges.shape:
        raise ValueError(f"angles {tuple(angles.shape)} vs edges "
                         f"{tuple(edges.shape)}")
    b, h, w = edges.shape
    if not 1 <= b <= MAX_PAGES or h < 1 or w < 1 or h * w > MAX_PAGE_PIXELS:
        raise ValueError(f"pages {tuple(edges.shape)}: the kernels "
                         f"take 1 <= B <= {MAX_PAGES} non-empty pages of at "
                         f"most {MAX_PAGE_PIXELS} pixels")
    if len(table) != 8 * NDIR or len(floats) != 4 * NDIR + 2:
        raise ValueError(f"a direction table of {len(table)} ints and "
                         f"{len(floats)} floats; the kernels take "
                         f"{8 * NDIR} and {4 * NDIR + 2}")
    dev = edges.device
    classes = torch.empty((b, h, w), dtype=torch.int8, device=dev)
    chain = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    maps = torch.empty((2, b, h, w), dtype=torch.float32, device=dev)
    state = torch.empty((2, b, h, w), dtype=torch.int32, device=dev)
    n_anchors = torch.empty(b, dtype=torch.int32, device=dev)
    _build.launch("pft_swt_maps", edges, angles.data_ptr(), edges.data_ptr(),
                  classes.data_ptr(), chain.data_ptr(), maps.data_ptr(),
                  state.data_ptr(), n_anchors.data_ptr(), b, h, w,
                  (ctypes.c_int * len(table))(*table),
                  (ctypes.c_float * len(floats))(*floats))
    launches += 1
    return maps[0], maps[1], n_anchors
