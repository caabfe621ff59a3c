"""Plane helpers of the plain reference: words and gray, shifts, window
sums, exact floods, small clusters and component labels.

Plain PyTorch, written from the unpaper and libpillowfight definitions
and the port's plain versions of its kernels, frozen here so that later
changes to the program cannot move the yardstick. Nothing here imports
the program. The float planes take the dtype of the gray plane they are
given (float32 for the reference, a lower precision for the control).
"""

from __future__ import annotations

import torch

# unpaper's and libpillowfight's constants, as the program states them
BLACK_THRESHOLD = 0.33   # a pixel is dark if gray < 0.33 * 255
WHITE_THRESHOLD = 0.9    # a pixel is non-white if gray < 0.9 * 255


def scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a scalar of like's float dtype and device."""
    dt = like.dtype if like.dtype.is_floating_point else torch.float32
    return torch.tensor(x, dtype=dt, device=like.device)


def words_s3(words: torch.Tensor) -> torch.Tensor:
    """int32 RGBA words [B,H,W] (R the low byte) -> int32 r + g + b."""
    return (words & 0xFF) + ((words >> 8) & 0xFF) + ((words >> 16) & 0xFF)


def words_gray(words: torch.Tensor, ft=torch.float32) -> torch.Tensor:
    """Gray = (r + g + b) / 3 as a product with the float 1/3, the form
    libpillowfight's compiled reference computes."""
    s3 = words_s3(words).to(ft)
    return s3 * torch.tensor(1.0 / 3.0, dtype=ft, device=words.device)


def wipe_white(words: torch.Tensor, wipe: torch.Tensor) -> torch.Tensor:
    """RGB of wiped pixels set to 255, alpha kept."""
    return torch.where(wipe, words | 0x00FFFFFF, words)


def shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], `fill` outside."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        out[..., y0:y1, x0:x1] = x[..., y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns (0 < n < 32)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def i32(v: int) -> int:
    """A uint32 bit pattern as the int32 of the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def popcount(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 bit patterns."""
    v = v - (lsr(v, 1) & 0x55555555)
    v = (v & 0x33333333) + (lsr(v, 2) & 0x33333333)
    v = (v + lsr(v, 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


# ------------------------------------------------------------ window sums

def n_blocks(n: int, size: int, step: int) -> int:
    """Whole windows of `size` at `step` along n pixels."""
    return max((n - size) // step + 1, 0)


def _cumsum0(x: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = 1
    zero = torch.zeros(shape, dtype=torch.int32, device=x.device)
    return torch.cat([zero, torch.cumsum(x, dim=dim, dtype=torch.int32)],
                     dim=dim)


def _window_sums(x, size, step, dim, nb):
    cs = _cumsum0(x, dim)
    starts = torch.arange(nb, device=x.device) * step
    return cs.index_select(dim, starts + size) - cs.index_select(dim, starts)


def block_sums(x: torch.Tensor, size: int, step: int, ft) -> torch.Tensor:
    """Exact integer sums of a bool or integer [B,H,W] plane over the
    windows [i*step, i*step+size) x [j*step, j*step+size), as ft."""
    nby = n_blocks(x.shape[1], size, step)
    nbx = n_blocks(x.shape[2], size, step)
    y = _window_sums(x, size, step, 1, nby)
    return _window_sums(y, size, step, 2, nbx).to(ft)


def _coverage_axis(blocks, n_pix, size, step, dim):
    nb = blocks.shape[dim]
    p = torch.arange(n_pix, device=blocks.device)
    hi = torch.clamp(p // step, max=nb - 1)
    lo = torch.clamp(torch.div(p - size, step, rounding_mode="floor") + 1,
                     min=0)
    cs = _cumsum0(blocks, dim)
    lo = torch.minimum(lo, hi + 1)
    return (cs.index_select(dim, hi + 1) - cs.index_select(dim, lo)) > 0


def coverage(blocks: torch.Tensor, shape: tuple, size: int,
             step: int) -> torch.Tensor:
    """bool block grid [B,nby,nbx] -> bool [B,H,W]: true where a selected
    block's footprint covers the pixel."""
    _, h, w = shape
    rows = _coverage_axis(blocks, h, size, step, 1)
    return _coverage_axis(rows, w, size, step, 2)


def line_counts(plane: torch.Tensor, ft) -> tuple:
    """(rows [B,H], cols [B,W]) counts of the set pixels, as ft."""
    rows = plane.sum(dim=2, dtype=torch.int32).to(ft)
    cols = plane.sum(dim=1, dtype=torch.int32).to(ft)
    return rows, cols


# ------------------------------------------------------------------ floods

def _seg_or(mask: torch.Tensor, r: torch.Tensor, dim: int) -> torch.Tensor:
    """r | (a reached pixel in the same run of mask along dim)."""
    n = mask.shape[dim]
    shape = [1] * mask.ndim
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    seed = r & mask
    out = seed
    for flip in (False, True):
        m, s = (mask.flip(dim), seed.flip(dim)) if flip else (mask, seed)
        last_seed = torch.cummax(torch.where(s, idx, -1), dim=dim).values
        last_gap = torch.cummax(torch.where(m, -1, idx), dim=dim).values
        hit = m & (last_seed > last_gap)
        out = out | (hit.flip(dim) if flip else hit)
    return out


def _dilate(r: torch.Tensor, k: int) -> torch.Tensor:
    """Chebyshev-ball dilation of radius k, by doubling shifts."""
    for dy, dx in ((0, 1), (1, 0)):
        c = 0
        while c < k:
            s = min(c + 1, k - c)
            r = (r | shift2d(r, s * dy, s * dx, False)
                 | shift2d(r, -s * dy, -s * dx, False))
            c += s
    return r


def flood(seeds: torch.Tensor, mask: torch.Tensor, leap: int = 1
          ) -> torch.Tensor:
    """Every mask pixel 8-connected to a seed, mask pixels within
    Chebyshev distance `leap` counting as neighbours: rounds of segmented
    OR along rows and columns and a gated dilation, to the fixed point."""
    mask = mask.to(torch.bool)
    leap = min(leap, max(mask.shape[-2:]))
    r = seeds.to(torch.bool) & mask
    while True:
        new = _seg_or(mask, r, 2)
        new = _seg_or(mask, new, 1)
        new = (_dilate(new, leap) & mask) | new
        if torch.equal(new, r):
            return r
        r = new


def small_clusters(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Pixels whose 8-connected cluster has at most k pixels. Each pixel
    carries a (2k+1)^2-bit board of the window offsets it reaches within
    j steps through the mask; after k steps the ball holds at most k
    pixels iff the cluster does."""
    mask = mask.to(torch.bool)
    if k < 1:
        return torch.zeros_like(mask)
    b, h, w = mask.shape
    s = 2 * k + 1
    nb = s * s
    nw = (nb + 31) // 32
    dev = mask.device
    mp = torch.nn.functional.pad(mask.to(torch.int32), (k, k, k, k))
    m_words = [torch.zeros((b, h, w), dtype=torch.int32, device=dev)
               for _ in range(nw)]
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            wi, o = divmod((dy + k) * s + (dx + k), 32)
            m_words[wi] |= mp[:, k + dy: k + dy + h, k + dx: k + dx + w] << o

    def valid_word(ex: int, wi: int) -> int:
        v = 0
        for bit in range(32):
            bb = wi * 32 + bit
            if bb < nb and -k <= bb % s - k - ex <= k:
                v |= 1 << bit
        return i32(v)

    dirs = [(ey, ex) for ey in (-1, 0, 1) for ex in (-1, 0, 1)
            if (ey, ex) != (0, 0)]
    valid = {d: [valid_word(d[1], wi) for wi in range(nw)] for d in dirs}
    zero = torch.zeros((b, h, w), dtype=torch.int32, device=dev)

    def bit_shift(words, amt):
        wo, bo = divmod(abs(amt), 32)
        out = []
        for wi in range(nw):
            src, carry = (wi - wo, wi - wo - 1) if amt > 0 else (
                wi + wo, wi + wo + 1)
            v = zero
            if 0 <= src < nw:
                v = words[src] if bo == 0 else (
                    words[src] << bo if amt > 0 else lsr(words[src], bo))
            if bo and 0 <= carry < nw:
                v = v | (lsr(words[carry], 32 - bo) if amt > 0
                         else words[carry] << (32 - bo))
            out.append(v)
        return out

    cw, co = divmod(k * s + k, 32)
    r = [torch.where(mask, i32(1 << co), 0).to(torch.int32) if wi == cw
         else zero for wi in range(nw)]
    for _ in range(k):
        acc = list(r)
        for d in dirs:
            shifted = bit_shift(r, d[0] * s + d[1])
            for wi in range(nw):
                acc[wi] = acc[wi] | (shifted[wi] & valid[d][wi])
        r = [acc[wi] & m_words[wi] for wi in range(nw)]
    size = sum(popcount(x) for x in r)
    return mask & (size <= k)


# ------------------------------------------------------------------ labels

OFFSETS = ((0, 1), (1, 0), (1, 1), (1, -1))  # the four undirected links


def _seg_min(v, linked_next, dim, big):
    """Min of v over each maximal linked run along dim, by doubling."""
    n = v.shape[dim]
    gaps = torch.cumsum((~linked_next).to(torch.int32), dim=dim,
                        dtype=torch.int32)
    e = torch.zeros_like(gaps)
    e.narrow(dim, 1, n - 1).copy_(gaps.narrow(dim, 0, n - 1))
    v = v.clone()
    d = 1
    while d < n:
        lo, hi = v.narrow(dim, 0, n - d), v.narrow(dim, d, n - d)
        same = e.narrow(dim, 0, n - d) == e.narrow(dim, d, n - d)
        hi.copy_(torch.minimum(hi, torch.where(same, lo, big)))
        lo.copy_(torch.minimum(lo, torch.where(same, hi, big)))
        d *= 2
    return v


def label_links(valid: torch.Tensor, links: dict) -> torch.Tensor:
    """Component labels under pairwise links {(dy,dx): bool [B,H,W]}
    over `OFFSETS`: the least flat index y*W + x of the component, H*W
    off `valid`."""
    valid = valid.to(torch.bool)
    b, h, w = valid.shape
    big = h * w
    planes = [links[d].to(torch.bool) & valid & shift2d(valid, d[0], d[1],
                                                         False)
              for d in OFFSETS]
    idx = torch.arange(big, dtype=torch.int32,
                       device=valid.device).view(1, h, w)
    labels = torch.where(valid, idx, big).to(torch.int32)
    while True:
        new = _seg_min(labels, planes[0], 2, big)
        new = _seg_min(new, planes[1], 1, big)
        out = new
        for (dy, dx), link in zip(OFFSETS, planes):
            out = torch.minimum(out, torch.where(
                link, shift2d(new, dy, dx, big), big))
            out = torch.minimum(out, torch.where(
                shift2d(link, -dy, -dx, False),
                shift2d(new, -dy, -dx, big), big))
        new = torch.where(valid, out, big)
        if torch.equal(new, labels):
            return labels
        labels = new
