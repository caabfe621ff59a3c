"""Shared helpers of the unpaper filters (port of
`libpillowfight_tpu/ops/unpaper/common.py`).

Block statistics are exact integer window sums (cumulative sums in
int32); the reference computes the same integers with XLA reductions.
Threshold compares are made in float32, as JAX casts a Python scalar to
the f32 dtype of the plane.
"""

from __future__ import annotations

import torch

from ...core import constants as C
from ...core.bitmap import (ensure_batched, maybe_unbatch, pages_to_words,
                            wipe_white_words, words_to_gray, words_to_pages)
from ..cuda.linecount import line_counts

__all__ = ["apply_wipe", "block_counts", "block_sums", "block_sums_u16",
           "coverage_from_blocks", "dark_mask", "f32", "line_counts",
           "nonwhite_mask", "wipe_white"]


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a float32 scalar tensor on like's device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def apply_wipe(pages: torch.Tensor, wipe_fn, **kwargs) -> torch.Tensor:
    """Single-filter wrapper: uint8 RGBA [B,H,W,4] or int32 words [B,H,W]
    (or one page) in, the same form out."""
    pages, unb = ensure_batched(pages)
    in_words = pages.dtype == torch.int32
    words = pages if in_words else pages_to_words(pages)
    out = wipe_white_words(words, wipe_fn(words_to_gray(words), **kwargs))
    if not in_words:
        out = words_to_pages(out)
    return maybe_unbatch(out, unb)


def dark_mask(gray: torch.Tensor,
              threshold: float = C.UNPAPER_BLACK_THRESHOLD) -> torch.Tensor:
    """Pixels considered 'black': gray < threshold * 255."""
    return gray < f32(threshold * 255.0, gray)


def nonwhite_mask(gray: torch.Tensor) -> torch.Tensor:
    """Pixels considered 'non-white': gray < 0.9 * 255."""
    return gray < f32(C.UNPAPER_WHITE_THRESHOLD * 255.0, gray)


def _n_blocks(n: int, size: int, step: int) -> int:
    """Number of whole windows; 0 when the window exceeds the page (the
    grid is then empty and covers nothing)."""
    if size < 1 or step < 1:
        raise ValueError(f"size={size} and step={step} must be >= 1")
    return max((n - size) // step + 1, 0)


def _cumsum0(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 cumulative sum along dim with a leading 0."""
    shape = list(x.shape)
    shape[dim] = 1
    zero = torch.zeros(shape, dtype=torch.int32, device=x.device)
    return torch.cat([zero, torch.cumsum(x, dim=dim, dtype=torch.int32)],
                     dim=dim)


def _window_sums(x: torch.Tensor, size: int, step: int, dim: int,
                 nb: int) -> torch.Tensor:
    """Sums over [i*step, i*step+size) along dim for i < nb (int32)."""
    cs = _cumsum0(x, dim)
    starts = torch.arange(nb, device=x.device) * step
    return cs.index_select(dim, starts + size) - cs.index_select(dim, starts)


def _block_sums(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    nby = _n_blocks(x.shape[1], size, step)
    nbx = _n_blocks(x.shape[2], size, step)
    y = _window_sums(x, size, step, 1, nby)
    return _window_sums(y, size, step, 2, nbx).to(torch.float32)


def _fold_windows(x: torch.Tensor, size: int, step: int,
                  dim: int) -> torch.Tensor:
    """f32 sums over [i*step, i*step+size) along dim, each a left fold
    of its window from 0.0, as the reference's `reduce_window` adds."""
    nb = _n_blocks(x.shape[dim], size, step)
    shape = list(x.shape)
    shape[dim] = nb
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    if nb == 0:
        return acc
    index = [slice(None)] * x.ndim
    for k in range(size):
        index[dim] = slice(k, k + (nb - 1) * step + 1, step)
        acc = acc + x[tuple(index)]
    return acc


def block_sums(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """Strided window sums of an f32 or bool [B,H,W] plane: f32
    [B,nby,nbx], cell (i,j) covering [i*step, i*step+size) x [j*step,
    j*step+size) (VALID windows only). Sums H first, then W, as the
    reference does. On no path of the port: the filters take the exact
    integer sums of `block_counts` and `block_sums_u16`."""
    y = _fold_windows(x.to(torch.float32), size, step, 1)
    return _fold_windows(y, size, step, 2)


def block_counts(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """Window counts of a bool [B,H,W] plane: f32 [B,nby,nbx], cell (i,j)
    covering [i*step, i*step+size) x [j*step, j*step+size). The
    reference is exact for size <= 256 (<= 127 past 256 block rows)."""
    check_counts_domain(x.shape[1], size, step)
    return _block_sums(x, size, step)


def check_counts_domain(h: int, size: int, step: int) -> None:
    """Raise unless `block_counts` takes windows of `size` at `step` on a
    plane of h rows."""
    nby = (h - size) // step + 1
    if size > 256 or (nby > 256 and size > 127):
        raise ValueError(f"size={size} is outside block_counts' domain "
                         f"(<= 256, or <= 127 for more than 256 block rows)")


def block_sums_u16(x: torch.Tensor, size: int, step: int) -> torch.Tensor:
    """Exact window sums of an s3 = r+g+b plane (values <= 765), f32
    [B,nby,nbx]. The reference is exact while size*765 < 65536."""
    if size * 765 >= 65536:
        raise ValueError(f"size={size} is outside block_sums_u16' domain "
                         f"(size*765 < 65536)")
    return _block_sums(x, size, step)


def _coverage_axis(blocks: torch.Tensor, n_pix: int, size: int, step: int,
                   dim: int) -> torch.Tensor:
    """Pixel p along dim is covered iff a selected block i (0 <= i < nb)
    has i*step <= p < i*step + size (the footprint rule of the
    reference's _expand_axis, pixels past the last block start
    included). Returns bool with dim expanded to n_pix."""
    nb = blocks.shape[dim]
    p = torch.arange(n_pix, device=blocks.device)
    hi = torch.clamp(p // step, max=nb - 1)                     # last block
    lo = torch.clamp(torch.div(p - size, step, rounding_mode="floor") + 1,
                     min=0)                                     # first block
    cs = _cumsum0(blocks, dim)
    lo = torch.minimum(lo, hi + 1)
    return (cs.index_select(dim, hi + 1) - cs.index_select(dim, lo)) > 0


def coverage_from_blocks(blocks: torch.Tensor, shape: tuple, size: int,
                         step: int) -> torch.Tensor:
    """bool grid [B,nby,nbx] -> bool [B,H,W], true where a selected
    block's footprint covers the pixel."""
    _, h, w = shape
    rows = _coverage_axis(blocks, h, size, step, 1)
    return _coverage_axis(rows, w, size, step, 2)


def wipe_white(pages: torch.Tensor, wipe: torch.Tensor) -> torch.Tensor:
    """Set RGB of wiped pixels of uint8 RGBA [B,H,W,4] to white."""
    out = pages.clone()
    out[..., :3] = torch.where(wipe[..., None], C.PF_WHITE, pages[..., :3])
    return out
