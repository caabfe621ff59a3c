"""Halo (ghost-row) exchange between the row shards of a page (port of
`libpillowfight_tpu/parallel/halo.py`).

When one page's rows are sharded, a stencil needs `halo` rows of context
from its neighbours. The reference passes them around a ring with
`ppermute`; here each ghost row is a device-to-device copy from the shard
that holds it: a peer copy between two cards, a plain copy on one device.
A halo taller than a shard takes its rows from as many neighbours as it
spans, and rows past the page's top and bottom are zero (the zero padding
of the reference's `pf_dbl_matrix_convolution`).
"""

from __future__ import annotations

import numpy as np
import torch

# the axis names, which the reference's halo module holds too
from .mesh import PAGES_AXIS, ROWS_AXIS  # noqa: F401
from .mesh import Mesh, ShardedPages, device_scope, shard_pages


def _offsets(blocks: list) -> list[int]:
    return np.cumsum([0] + [b.shape[-2] for b in blocks]).tolist()


def row_slab(blocks: list, lo: int, hi: int,
             device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of the page whose row blocks (top to bottom, rows
    along -2) are `blocks`, one contiguous tensor on `device`.
    0 <= lo < hi <= H."""
    offs = _offsets(blocks)
    parts = [b[..., max(lo, o0) - o0: min(hi, o1) - o0, :].to(device)
             for b, o0, o1 in zip(blocks, offs, offs[1:])
             if o0 < hi and lo < o1]
    return torch.cat(parts, dim=-2) if len(parts) > 1 else \
        parts[0].contiguous()


def exchange_halo_rows(blocks: list, halo: int) -> list:
    """Append `halo` ghost rows from the neighbours above and below.

    blocks: the row blocks of one page column, top to bottom, each
    [..., h_j, W] on its device. Returns each as [..., h_j + 2*halo, W] on
    its device; ghost rows past the page's top and bottom are zero."""
    offs = _offsets(blocks)
    h = offs[-1]
    out = []
    for b, o0, o1 in zip(blocks, offs, offs[1:]):
        lo, hi = o0 - halo, o1 + halo
        top, bottom = (b.new_zeros((*b.shape[:-2], max(n, 0), b.shape[-1]))
                       for n in (-lo, hi - h))
        rows = row_slab(blocks, max(lo, 0), min(hi, h), b.device)
        out.append(torch.cat([top, rows, bottom], dim=-2))
    return out


def stencil_rows(blocks: list, halo: int, fn) -> list:
    """fn of each row block of a page column plus `halo` exchanged rows
    above and below (zeros past the page), on the block's device; the
    block's own rows of the result (a tensor, or a tuple of tensors)."""
    out = []
    for b, slab in zip(blocks, exchange_halo_rows(blocks, halo)):
        with device_scope(b.device):
            r = fn(slab)
        own = [t[..., halo: halo + b.shape[-2], :]
               for t in (r if isinstance(r, tuple) else (r,))]
        out.append(tuple(own) if isinstance(r, tuple) else own[0])
    return out


def sharded_stencil(fn, mesh: Mesh, halo: int):
    """Wrap fn([B,H,W]) -> [B,H,W] to run rows-sharded with halo exchange.

    fn must be local (an output pixel depends on <= halo rows of context)
    and pad with zeros at the page's edges. The returned function takes a
    [B,H,W] batch (placed by `shard_pages`) or a ShardedPages and returns
    a ShardedPages; each shard runs fn on its device."""
    def run(x) -> ShardedPages:
        x = x if isinstance(x, ShardedPages) else shard_pages(x, mesh)
        out = np.empty_like(x.shards)
        for i, column in enumerate(x.shards):
            for j, r in enumerate(stencil_rows(list(column), halo, fn)):
                out[i, j] = r
        return ShardedPages(out, x.mesh)

    return run
