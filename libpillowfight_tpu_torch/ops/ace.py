"""ACE, automatic color equalization (port of `libpillowfight_tpu/ops/ace.py`).

Per pixel p, channel c, values in 0..255:
    R_c(p)  = sum_s sat(slope * (I_c(p) - I_c(s))) / d(p, s)
    Rmax(p) = sum_s limit / d(p, s)
    out_c   = round(255 * (n_c - min_c) / (max_c - min_c)),  n_c = R_c / Rmax
with sat(x) = clamp(x, -limit, limit), d the euclidean distance (min 1)
and min_c/max_c the per-page extrema of n_c (a flat channel maps to 127.5).

Three estimators, as in the reference:
* ``shared`` (default): S sample positions per page, shared by every
  pixel; the spray kernel (`ops/cuda/ace.py`) for CUDA tensors.
* ``rolled``: sample s of pixel p is (p + D_s) mod (H, W), one offset D_s
  per step and page; plain torch (the reference runs it in XLA).
* ``per_pixel``: independent per-pixel samples; plain torch, chunked.

`ace()` draws its samples from a `torch.Generator` seeded with `seed`.
Its numbers differ from jax.random's threefry, so a seeded run matches
the reference in distribution only; the functions that take explicit
samples, offsets or indices match it value for value.
"""

from __future__ import annotations

import torch

from ..core import constants as C
from ..core.bitmap import ensure_batched, maybe_unbatch, to_uint8
from .cuda.ace import ace_spray

_PER_PIXEL_CHUNK = 8  # samples drawn and summed at a time (the reference's)


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as a true division (torch computes `scalar / tensor` as a
    reciprocal times the scalar, which rounds differently)."""
    return torch.full_like(t, c) / t


def channel_extrema(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of n f32 [B,H,W,3] per page and channel, [B,1,1,3] each."""
    return (torch.amin(n, dim=(1, 2), keepdim=True),
            torch.amax(n, dim=(1, 2), keepdim=True))


def _rescale(n: torch.Tensor, extrema=None) -> torch.Tensor:
    """Per-page per-channel min-max stretch of n f32 [B,H,W,3] to uint8,
    by the page's (lo, hi) (`channel_extrema` of n when not given: a row
    shard passes its page's)."""
    lo, hi = channel_extrema(n) if extrema is None else extrema
    span = hi - lo
    stretched = torch.where(span > 1e-9,
                            255.0 * (n - lo) / torch.clamp(span, min=1e-9),
                            torch.full_like(n, 127.5))
    return to_uint8(stretched)


def with_alpha(n: torch.Tensor, pages: torch.Tensor,
               extrema=None) -> torch.Tensor:
    """The stretched n with the pages' alpha: the uint8 RGBA result."""
    return torch.cat([_rescale(n, extrema), pages[..., 3:]], dim=-1)


def spray_inputs(pages: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(planar f32 [B,3,H,W], sample values f32 [B,3,S]) of uint8 RGBA
    pages [B,H,W,4] and sample coordinates int32 [B,S]."""
    b, h, w, _ = pages.shape
    planar = to_planar(pages)
    flat = (sy.to(torch.int64) * w + sx.to(torch.int64))  # [B,S]
    sval = torch.gather(planar.reshape(b, 3, h * w), 2,
                        flat[:, None, :].expand(b, 3, flat.shape[1]))
    return planar, sval.contiguous()


def to_planar(pages: torch.Tensor) -> torch.Tensor:
    """The RGB planes of uint8 RGBA pages, f32 [B,3,H,W]."""
    return pages[..., :3].to(torch.float32).permute(0, 3, 1, 2).contiguous()


def spray_ratio(num: torch.Tensor, invd: torch.Tensor,
                limit: float) -> torch.Tensor:
    """n = num / (limit * invd), f32 [B,H,W,3], of the spray sums."""
    return num.permute(0, 2, 3, 1) / (limit * invd)[..., None]


def from_spray(pages: torch.Tensor, num: torch.Tensor, invd: torch.Tensor,
               limit: float) -> torch.Tensor:
    """The uint8 RGBA result of the spray sums: n = num / (limit * invd),
    stretched per channel, alpha passed through."""
    return with_alpha(spray_ratio(num, invd, limit), pages)


def ace_with_samples(pages: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     slope: float, limit: float) -> torch.Tensor:
    """Shared-sample ACE. pages uint8 [B,H,W,4]; sy/sx int32 [B,S] on the
    pages' device."""
    planar, sval = spray_inputs(pages, sy, sx)
    num, invd = ace_spray(planar, sy.to(torch.int32).contiguous(),
                          sx.to(torch.int32).contiguous(), sval, float(slope),
                          float(limit))
    return from_spray(pages, num, invd, limit)


def _pixel_sample_accum(rgb: torch.Tensor, idx: torch.Tensor, slope: float,
                        limit: float, row0: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(num [B,h,W,3], den [B,h,W,1]) of the page rows [row0, row0 + h)
    against their per-pixel flat sample indices idx int [B,h,W,S] into
    the page rgb f32 [B,H,W,3]."""
    b, _, w, _ = rgb.shape
    h, s = idx.shape[1], idx.shape[-1]
    idx = idx.to(torch.int64)
    flat = rgb.reshape(b, -1, 3)
    svals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, 3))
    svals = svals.reshape(b, h, w, s, 3)
    py = torch.arange(row0, row0 + h, device=rgb.device)[None, :, None, None]
    px = torch.arange(w, device=rgb.device)[None, None, :, None]
    dy = (idx // w - py).to(torch.float32)
    dx = (idx % w - px).to(torch.float32)
    d = torch.clamp(torch.sqrt(dy * dy + dx * dx), min=1.0)[..., None]
    delta = rgb[:, row0:row0 + h, :, None, :] - svals
    num = torch.sum(torch.clamp(slope * delta, -limit, limit) / d, dim=3)
    den = torch.sum(_rdiv(limit, d), dim=3)
    return num, den


def ace_with_pixel_samples(pages: torch.Tensor, idx: torch.Tensor,
                           slope: float, limit: float) -> torch.Tensor:
    """Per-pixel-sample ACE with explicit flat sample indices idx
    [B,H,W,S]: pixel (y, x) uses its own S samples."""
    return ace_per_pixel(pages, [idx], slope, limit)


def ace_per_pixel(pages: torch.Tensor, idx_chunks, slope: float,
                  limit: float) -> torch.Tensor:
    """`per_pixel` ACE from its index chunks (each int [B,H,W,chunk]),
    summed chunk by chunk as the reference's scan sums them."""
    rgb = pages[..., :3].to(torch.float32)
    num = den = None
    for idx in idx_chunks:
        dn, dd = _pixel_sample_accum(rgb, idx, slope, limit)
        num = dn if num is None else num + dn
        den = dd if den is None else den + dd
    return with_alpha(num / den, pages)


def rolled_ratio(rgb: torch.Tensor, dys: torch.Tensor, dxs: torch.Tensor,
                 slope: float, limit: float, row0: int = 0,
                 n_rows: int | None = None) -> torch.Tensor:
    """n = num / den of `rolled` ACE for the page rows [row0, row0 +
    n_rows) (default: all), rgb f32 [B,H,W,3] the whole page: sample s of
    pixel p is (p + (dys[s], dxs[s])) mod (H, W), at the signed distance
    of the wrapped position."""
    b, h, w, _ = rgb.shape
    n_rows = h - row0 if n_rows is None else n_rows
    dev = rgb.device
    dys = dys.to(device=dev, dtype=torch.int64)
    dxs = dxs.to(device=dev, dtype=torch.int64)
    py = torch.arange(row0, row0 + n_rows, device=dev)
    px = torch.arange(w, device=dev)
    own = rgb[:, row0:row0 + n_rows]
    pages_idx = torch.arange(b, device=dev)[:, None, None]
    num = torch.zeros((b, n_rows, w, 3), dtype=torch.float32, device=dev)
    den = torch.zeros((b, n_rows, w, 1), dtype=torch.float32, device=dev)
    for dy, dx in zip(dys, dxs):  # [B] each
        ys = py[None] + dy[:, None]   # [B,n_rows]
        xs = px[None] + dx[:, None]   # [B,W]
        rolled = rgb[pages_idx, (ys % h)[:, :, None], (xs % w)[:, None, :]]
        ey = torch.where(ys >= h, dy[:, None] - h, dy[:, None])
        ex = torch.where(xs >= w, dx[:, None] - w, dx[:, None])
        d2 = (ey * ey)[:, :, None] + (ex * ex)[:, None, :]
        d = torch.clamp(torch.sqrt(d2.to(torch.float32)), min=1.0)[..., None]
        num = num + torch.clamp(slope * (own - rolled), -limit, limit) / d
        den = den + _rdiv(limit, d)
    return num / den


def ace_rolled(pages: torch.Tensor, dys: torch.Tensor, dxs: torch.Tensor,
               slope: float, limit: float) -> torch.Tensor:
    """`rolled` ACE with explicit offsets dys, dxs int [S,B]."""
    rgb = pages[..., :3].to(torch.float32)
    return with_alpha(rolled_ratio(rgb, dys, dxs, slope, limit), pages)


def sample_coords(seed: int, b: int, s: int, h: int, w: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared samples `ace(mode="shared")` draws: (sy, sx) int32
    [B,S], from a CPU generator so that both devices draw the same."""
    g = torch.Generator().manual_seed(int(seed))
    sy = torch.randint(0, h, (b, s), generator=g, dtype=torch.int32)
    sx = torch.randint(0, w, (b, s), generator=g, dtype=torch.int32)
    return sy, sx


def rolled_offsets(seed: int, b: int, s: int, h: int, w: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The offsets `ace(mode="rolled")` draws: (dys, dxs) int64 [S,B],
    from a CPU generator."""
    g = torch.Generator().manual_seed(int(seed))
    dys = torch.randint(0, h, (s, b), generator=g)
    dxs = torch.randint(0, w, (s, b), generator=g)
    return dys, dxs


def pixel_index_chunks(seed: int, b: int, s: int, h: int, w: int,
                       device: torch.device):
    """The index chunks `ace(mode="per_pixel")` draws, one at a time:
    int64 [B,H,W,8] each, ceil(S / 8) of them, from a generator on
    `device` (so a seed draws alike only on one kind of device)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    for _ in range(-(-s // _PER_PIXEL_CHUNK)):
        yield torch.randint(0, h * w, (b, h, w, _PER_PIXEL_CHUNK),
                            generator=g, device=device)


def ace(pages: torch.Tensor, nb_samples: int = C.ACE_DEFAULT_NB_SAMPLES,
        slope: float = C.ACE_DEFAULT_SLOPE, limit: float = C.ACE_DEFAULT_LIMIT,
        seed: int = C.ACE_DEFAULT_SEED, mode: str = "shared",
        nb_threads: int = C.ACE_DEFAULT_NB_THREADS,  # API parity; ignored
        ) -> torch.Tensor:
    """uint8 RGBA [B,H,W,4] (or one page) -> equalized uint8 RGBA.

    `shared` and `rolled` draw their [B,S] samples or [S,B] offsets on
    the CPU, so a seed gives the same result on either device;
    `per_pixel` draws its [B,H,W,chunk] indices on the pages' device."""
    del nb_threads
    pages, unb = ensure_batched(pages)
    b, h, w, _ = pages.shape
    slope, limit = float(slope), float(limit)
    if mode == "shared":
        sy, sx = sample_coords(seed, b, nb_samples, h, w)
        out = ace_with_samples(pages, sy.to(pages.device),
                               sx.to(pages.device), slope, limit)
    elif mode == "rolled":
        out = ace_rolled(pages, *rolled_offsets(seed, b, nb_samples, h, w),
                         slope, limit)
    elif mode == "per_pixel":
        out = ace_per_pixel(pages, pixel_index_chunks(
            seed, b, nb_samples, h, w, pages.device), slope, limit)
    else:
        raise ValueError(f"unknown ace mode {mode!r}")
    return maybe_unbatch(out, unb)
