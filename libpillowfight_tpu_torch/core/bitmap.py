"""Batched RGBA pages and their word / gray views, and the host-side
PIL, PPM and word helpers (port of `libpillowfight_tpu/core/bitmap.py`).

Pages are uint8 RGBA [B,H,W,4]; words are the same bytes viewed as
**int32** [B,H,W] (R = low byte). torch's uint32 has no `>>` or `>` on
the CPU, so words are signed: every `>>` is masked with 0xFF, or an
alpha byte >= 128 would sign-extend into B.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C


def ensure_batched(img: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Return (batched_img, was_unbatched). Accepts [H,W], [H,W,4],
    [B,H,W], [B,H,W,4]."""
    if img.ndim == 2:
        return img[None], True
    if img.ndim == 3:
        if img.shape[-1] == 4:
            return img[None], True
        return img, False
    if img.ndim == 4:
        return img, False
    raise ValueError(f"unsupported image rank {img.ndim}: shape "
                     f"{tuple(img.shape)}")


def maybe_unbatch(img: torch.Tensor, was_unbatched: bool) -> torch.Tensor:
    return img[0] if was_unbatched else img


def pages_to_words(pages: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4] RGBA -> int32 [...] words (same bytes)."""
    return pages.contiguous().view(torch.int32).squeeze(-1)


def words_to_pages(words: torch.Tensor) -> torch.Tensor:
    """int32 [...] words -> uint8 [..., 4] RGBA (same bytes)."""
    return words.contiguous().unsqueeze(-1).view(torch.uint8)


def rgba_to_gray(pages: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,4] -> f32 [B,H,W] in [0,255], unweighted RGB mean."""
    rgb = pages[..., :3].to(torch.int32)
    return _third(rgb[..., 0] + rgb[..., 1] + rgb[..., 2])


def _third(s3: torch.Tensor) -> torch.Tensor:
    """f32 (r+g+b)/3 as the reference's compiled program computes it:
    XLA rewrites the division by 3.0 into a product with f32(1/3), one
    ulp off the exact quotient for some sums. torch's CUDA division by a
    scalar does the same and its CPU division does not, so the product is
    written out to be the same on both devices."""
    return s3.to(torch.float32) * torch.tensor(1.0 / 3.0, dtype=torch.float32,
                                               device=s3.device)


def _channels(words: torch.Tensor):
    r = words & 0xFF
    g = (words >> 8) & 0xFF
    b = (words >> 16) & 0xFF
    return r, g, b


def words_to_s3(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int32 r+g+b in [0, 765], the exact form of
    3*gray."""
    r, g, b = _channels(words)
    return r + g + b


def words_to_gray(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> f32 gray, bit-identical to rgba_to_gray."""
    return _third(words_to_s3(words))


def wipe_white_words(words: torch.Tensor, wipe: torch.Tensor) -> torch.Tensor:
    """Set the RGB bytes of wiped pixels to 255, keeping alpha."""
    return torch.where(wipe, words | 0x00FFFFFF, words)


def gray_to_rgba(gray: torch.Tensor) -> torch.Tensor:
    """f32 [B,H,W] in [0,255] -> uint8 RGBA [B,H,W,4], opaque alpha."""
    v = to_uint8(gray)
    return torch.stack([v, v, v, torch.full_like(v, 255)], dim=-1)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, clip to [0,255], cast."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def normalize(matrix: torch.Tensor) -> torch.Tensor:
    """Per-page min-max rescale of f32 [B,H,W] to [0,255]; flat pages
    map to 0. `255 / span` is a true division: torch computes
    `scalar / tensor` as a reciprocal times the scalar, which rounds
    differently."""
    lo = torch.amin(matrix, dim=(-2, -1), keepdim=True)
    hi = torch.amax(matrix, dim=(-2, -1), keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    return (matrix - lo) * (torch.full_like(span, 255.0) / span)


def compare(a: torch.Tensor, b: torch.Tensor,
            tolerance: int = C.COMPARE_DEFAULT_TOLERANCE
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel diff of two RGBA batches of one shape, uint8 [B,H,W,4]:
    (pixels a page whose R, G or B differ by more than `tolerance`, int32
    [B]; the diff bitmap, uint8 [B,H,W,4]: white where the pixels match,
    the absolute channel difference where they do not, alpha 255)."""
    if a.shape != b.shape or a.shape[-1] != 4:
        raise ValueError(f"compare takes two RGBA batches of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    delta = (a[..., :3].to(torch.int16) - b[..., :3].to(torch.int16)).abs()
    differs = (delta > tolerance).any(dim=-1)
    n_diff = differs.sum(dim=(-2, -1), dtype=torch.int32)
    diff = torch.full_like(a, 255)
    diff[..., :3] = torch.where(differs[..., None], delta.to(torch.uint8), 255)
    return n_diff, diff


def shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], `fill` outside."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        out[..., y0:y1, x0:x1] = x[..., y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


# --------------------------------------------------------------------------
# host-side conversions (PIL / numpy)
# --------------------------------------------------------------------------

def from_pil(img) -> np.ndarray:
    """PIL.Image -> uint8 RGBA [H, W, 4] (host numpy)."""
    return np.asarray(img.convert("RGBA"), dtype=np.uint8)


def to_pil(arr):
    """uint8 RGBA [H, W, 4] -> PIL.Image (PIL is imported here, so that
    the package imports without it)."""
    from PIL import Image

    return Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="RGBA")


def write_ppm(path: str, arr) -> None:
    """Debug dump of RGBA, RGB or gray uint8 as binary PPM (ref: util.c
    pf_write_bitmap_to_ppm)."""
    a = np.asarray(arr)
    if a.ndim == 3 and a.shape[-1] == 4:
        a = a[..., :3]
    elif a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    a = a.astype(np.uint8)
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(a.tobytes())


def host_pages_to_words(pages: np.ndarray) -> np.ndarray:
    """Free numpy view: uint8 [B,H,W,4] -> uint32 [B,H,W], as the
    reference's. The port's words are int32: take `.view(np.int32)`
    before `torch.from_numpy`."""
    pages = np.ascontiguousarray(pages, np.uint8)
    return pages.view(np.uint32).reshape(pages.shape[:-1])


def host_words_to_pages(words: np.ndarray) -> np.ndarray:
    """Free numpy view: uint32 [B,H,W] -> uint8 [B,H,W,4] (int32 words
    cast to uint32 keep their bits)."""
    words = np.ascontiguousarray(words, np.uint32)
    return words.view(np.uint8).reshape(words.shape + (4,))
