"""ACE on pages whose rows are sharded over devices.

The reference has no module for this: GSPMD partitions `ace` over a
(pages, rows) mesh. Every mode draws what the unsharded `ace` draws for
the whole batch, from the same seed, and each row shard computes its own
rows' sums; the page's per-channel extrema of n = num / den are a min and
a max over the shards, and each shard stretches by them. The result is
the unsharded one bit for bit:

* `shared`: the page's S samples are drawn once, with the page's H and
  W. Each shard gathers the sample values that lie in its rows, and the
  page's [B,3,S] values are put together on every shard's device. The
  shard then runs the spray (the kernel on a card) on its own rows with
  `sy - row0` and the same `sx`: the spray uses the coordinates only for
  dy = y - sy, an exact integer in f32, so every pixel's sums are the
  unsharded ones in the same order;
* `rolled`: a pixel's sample is (p + D_s) mod (H, W), anywhere in the
  page, and the offsets differ by page: each shard gathers its page
  column's RGBA once a call (H*W*4 bytes a page) and takes its f32 RGB
  (12 bytes a pixel), as much as the unsharded call holds. The signed
  wrapped distance uses the global row;
* `per_pixel`: samples land anywhere in the page, so each shard gathers
  the whole page the same way. This all-gather is the one exception to
  the halo exchanges of the sharded filters. Each index chunk is drawn
  for the whole batch on the first shard's device, with the generator
  `ace` seeds, and each shard takes its pages' and rows' indices: a
  seeded run is bit-identical to the unsharded call on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..ops.ace import (_pixel_sample_accum, channel_extrema,
                       pixel_index_chunks, rolled_offsets, rolled_ratio,
                       sample_coords, spray_ratio, to_planar, with_alpha)
from ..ops.cuda.ace import ace_spray
from .mesh import ShardedPages, device_scope
from .spatial import Column, across, map_columns


def _stretch(n: list, blocks: list) -> list:
    """Each shard's uint8 RGBA from its n [b,h,W,3], by the page's
    per-channel extrema."""
    lo, hi = zip(*map(channel_extrema, n))
    lo, hi = across(list(lo), torch.minimum), across(list(hi), torch.maximum)
    return [with_alpha(t, p, e) for t, p, e in zip(n, blocks, zip(lo, hi))]


def _shared(blocks: list, sy: torch.Tensor, sx: torch.Tensor, slope: float,
            limit: float) -> list:
    col = Column(blocks)
    w = blocks[0].shape[2]
    planar = [to_planar(p) for p in blocks]
    dev0 = blocks[0].device
    sval = None
    for j, pl in enumerate(planar):
        o, h = col.rows(j)
        ys, xs = sy.to(pl.device), sx.to(pl.device)
        mine = (ys >= o) & (ys < o + h)
        flat = ((ys - o).clamp(0, h - 1) * w + xs).to(torch.int64)
        vals = torch.gather(pl.reshape(*pl.shape[:2], -1), 2,
                            flat[:, None, :].expand(-1, 3, -1)).to(dev0)
        mine = mine[:, None, :].to(dev0)
        sval = torch.where(mine, vals, 0.0 if sval is None else sval)
    n = []
    for j, pl in enumerate(planar):
        o, _ = col.rows(j)
        dev = pl.device
        with device_scope(dev):
            num, invd = ace_spray(
                pl, (sy - o).to(device=dev, dtype=torch.int32).contiguous(),
                sx.to(device=dev, dtype=torch.int32).contiguous(),
                sval.to(dev).contiguous(), slope, limit)
            n.append(spray_ratio(num, invd, limit))
    return _stretch(n, blocks)


def _page_rgb(blocks: list, dev: torch.device) -> torch.Tensor:
    """The page column's f32 RGB [b,H,W,3] on `dev`."""
    return torch.cat([p[..., :3].to(dev) for p in blocks],
                     dim=1).to(torch.float32)


def _rolled(blocks: list, dys: torch.Tensor, dxs: torch.Tensor,
            slope: float, limit: float) -> list:
    col = Column(blocks)
    n = []
    for j, p in enumerate(blocks):
        o, h = col.rows(j)
        with device_scope(p.device):
            n.append(rolled_ratio(_page_rgb(blocks, p.device), dys, dxs,
                                  slope, limit, row0=o, n_rows=h))
    return _stretch(n, blocks)


def _per_pixel(x: ShardedPages, seed: int, nb_samples: int, slope: float,
               limit: float) -> ShardedPages:
    b, h, w = x.shape[:3]
    shards = dict(np.ndenumerate(x.shards))
    rgb = {ij: _page_rgb(list(x.shards[ij[0]]), s.device)
           for ij, s in shards.items()}
    sums = {}  # (num, den) of each shard, summed chunk by chunk
    for chunk in pixel_index_chunks(seed, b, nb_samples, h, w,
                                    x.shards[0, 0].device):
        for (i, j), s in shards.items():
            p0, p1 = x.page_offsets[i], x.page_offsets[i + 1]
            o, o1 = x.row_offsets[j], x.row_offsets[j + 1]
            with device_scope(s.device):
                dn, dd = _pixel_sample_accum(
                    rgb[i, j], chunk[p0:p1, o:o1].to(s.device), slope, limit,
                    row0=o)
            old = sums.get((i, j))
            sums[i, j] = (dn, dd) if old is None else (old[0] + dn,
                                                       old[1] + dd)
    del rgb
    col_of = {p0: i for i, p0 in enumerate(x.page_offsets[:-1])}
    return map_columns(x, lambda blocks, p0: _stretch(
        [num / den for num, den in (sums[col_of[p0], j]
                                    for j in range(len(blocks)))], blocks))


def sharded_ace(x: ShardedPages, nb_samples: int = C.ACE_DEFAULT_NB_SAMPLES,
                slope: float = C.ACE_DEFAULT_SLOPE,
                limit: float = C.ACE_DEFAULT_LIMIT,
                seed: int = C.ACE_DEFAULT_SEED, mode: str = "shared",
                nb_threads: int = C.ACE_DEFAULT_NB_THREADS) -> ShardedPages:
    """`ops.ace` of uint8 RGBA pages sharded over pages and rows."""
    del nb_threads
    b, h, w = x.shape[:3]
    slope, limit = float(slope), float(limit)
    if mode == "shared":
        sy, sx = sample_coords(seed, b, nb_samples, h, w)
        return map_columns(x, lambda blocks, p0: _shared(
            blocks, sy[p0:p0 + blocks[0].shape[0]],
            sx[p0:p0 + blocks[0].shape[0]], slope, limit))
    if mode == "rolled":
        dys, dxs = rolled_offsets(seed, b, nb_samples, h, w)
        return map_columns(x, lambda blocks, p0: _rolled(
            blocks, dys[:, p0:p0 + blocks[0].shape[0]],
            dxs[:, p0:p0 + blocks[0].shape[0]], slope, limit))
    if mode == "per_pixel":
        return _per_pixel(x, seed, nb_samples, slope, limit)
    raise ValueError(f"unknown ace mode {mode!r}")
