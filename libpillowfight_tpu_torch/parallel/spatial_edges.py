"""Gaussian, sobel and the canny stack on pages whose rows are sharded
over devices.

The reference has no module for this: GSPMD partitions its filters over
a (pages, rows) mesh. Here each row shard runs the port's functions, with
their kernels, on its own rows plus a halo, and every result is the
unsharded one bit for bit:

* the blur: one `exchange_halo_rows` of the planes at the taps'
  half-width, the blur of the slab, the shard's rows cut out. Ghost rows
  past the page's ends are zeros, the blur's own zero padding;
* sobel: a second exchange, of the *smoothed* plane, at halo 1. One
  exchange of the gray plane at halo 11 would be wrong: sobel sees zeros
  past the page's edge, where the blur of a slab leaves non-zero values
  in the rows past it;
* canny: `hypot`'s extrema of the page (a min and a max over the shards)
  normalize each shard's intensity; NMS reads one halo row of the rounded
  intensity (zeros past the page) beside the shard's own gradients; the
  thresholds are fractions of the page's peak (a max over the shards);
  the hysteresis is `spatial.flood` at leap 1, by rounds of exchanges.

`canny_rows` gives each shard's (gx, gy, edges), which SWT reuses
(`spatial_swt.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import constants as C
from ..core.bitmap import gray_to_rgba, rgba_to_gray, to_uint8
from ..ops.canny import _nms, canny_intensity, canny_threshold
from ..ops.conv import gaussian_taps
from ..ops.cuda.gaussian import gaussian_sep
from ..ops.sobel import hypot, sobel_gradients
from .halo import exchange_halo_rows, stencil_rows
from .mesh import ShardedPages
from .spatial import Column, across, flood, map_columns


def blur_rows(planes: list, taps) -> list:
    """The blur of a page column's f32 planes [N, h_j, W] by `taps`."""
    return stencil_rows(planes, len(taps) // 2,
                        lambda s: gaussian_sep(s, taps))


def sobel_rows(gray: list) -> list:
    """(gx, gy) of each block of a page column's f32 plane."""
    return stencil_rows(gray, 1, sobel_gradients)


def canny_rows(gray: list) -> tuple[list, list, list]:
    """Each row shard's (gx, gy, edges) of a page column's f32 gray
    blocks [B, h_j, W]: the smoothed gradients and canny's edge mask."""
    taps = gaussian_taps(C.CANNY_GAUSSIAN_SIGMA, C.CANNY_GAUSSIAN_NB_STDDEV)
    gx, gy = zip(*sobel_rows(blur_rows(gray, taps)))
    inten = [hypot(a, b) for a, b in zip(gx, gy)]
    lo = across([torch.amin(t, dim=(-2, -1), keepdim=True) for t in inten],
                torch.minimum)
    hi = across([torch.amax(t, dim=(-2, -1), keepdim=True) for t in inten],
                torch.maximum)
    inten_q = [canny_intensity(t, a, b) for t, a, b in zip(inten, lo, hi)]
    del inten

    def pad(t):  # rows past the shard: NMS reads them in the slab only
        return F.pad(t, (0, 0, 1, 1))

    nms = [_nms(q, pad(a), pad(b))[:, 1:-1] for q, a, b in zip(
        exchange_halo_rows(inten_q, 1), gx, gy)]
    peak = across([torch.amax(t, dim=(-2, -1), keepdim=True) for t in nms],
                  torch.maximum)
    strong, weak = zip(*(canny_threshold(t, p) for t, p in zip(nms, peak)))
    edges = flood(Column(gray), list(strong), list(weak), leap=1)
    return list(gx), list(gy), edges


def sharded_gaussian(x: ShardedPages, sigma: float = C.GAUSSIAN_DEFAULT_SIGMA,
                     nb_stddev: int = C.GAUSSIAN_DEFAULT_NB_STDDEV
                     ) -> ShardedPages:
    """`ops.gaussian` of uint8 RGBA pages sharded over pages and rows."""
    taps = gaussian_taps(sigma, nb_stddev)

    def column(blocks, _):
        planes = [p[..., :3].permute(0, 3, 1, 2).to(torch.float32)
                  .reshape(-1, *p.shape[1:3]).contiguous() for p in blocks]
        out = []
        for p, blurred in zip(blocks, blur_rows(planes, taps)):
            b, h, w, _ = p.shape
            rgb = to_uint8(blurred.reshape(b, 3, h, w).permute(0, 2, 3, 1))
            out.append(torch.cat([rgb, p[..., 3:]], dim=-1))
        return out

    return map_columns(x, column)


def sharded_sobel(x: ShardedPages) -> ShardedPages:
    """`ops.sobel` of uint8 RGBA pages sharded over pages and rows."""
    def column(blocks, _):
        return [gray_to_rgba(torch.clamp(hypot(gx, gy), 0.0, 255.0))
                for gx, gy in sobel_rows([rgba_to_gray(p) for p in blocks])]

    return map_columns(x, column)


def sharded_canny(x: ShardedPages) -> ShardedPages:
    """`ops.canny` of uint8 RGBA pages sharded over pages and rows."""
    def column(blocks, _):
        _, _, edges = canny_rows([rgba_to_gray(p) for p in blocks])
        return [gray_to_rgba(e.to(torch.float32) * 255.0) for e in edges]

    return map_columns(x, column)
