"""Bit-packed exact flood (kernels in `csrc/flood_packed.cu`).

Replaces `libpillowfight_tpu/ops/pallas/flood_packed.py`: `_pack_kernel`
and `_unpack_kernel` (`pack_rows`, `unpack_rows`) and the three round
kernels `_lanes_kernel`, `_rows_kernel`, `_dilate_kernel` driven by
`_flood_packed`: here one kernel that runs every round of a flood.

Packed planes are int32 [B, ceil(H/32), W] (the bits of the reference's
uint32 words): bit k of word (q, x) is pixel (32q + k, x). The kernel
stages one packed row and one 32-column strip of a page in a block's
shared memory, which allows pages up to about 19,000 x 19,000 pixels; a
larger one raises.
"""

from __future__ import annotations

import torch

from ... import _build
from . import expect, use_kernel

# launch counts of the kernel wrappers; "flood_round" counts floods: the
# kernel runs all the rounds of a flood in one launch
launches = {"pack_rows": 0, "unpack_rows": 0, "flood_round": 0}
# int32 [4] on the flood's device; [3] = rounds of the last flood, the
# final one that changes nothing included (the plain version fills [3])
last_info = None
MAX_SHARED_BYTES = 232_448 - 4096  # a block's dynamic share, less the static


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns (0 < n < 32)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


# ------------------------------------------------------------ pack/unpack

def pack_rows_plain(plane: torch.Tensor) -> torch.Tensor:
    """bool or uint8 [B,H,W] -> int32 [B,ceil(H/32),W] packed words: bit
    k of word (q, x) is set where pixel (32q + k, x) is not 0, as the
    kernel packs it (a uint8 value above 1 sets one bit, not its own)."""
    b, h, w = plane.shape
    hq = (h + 31) // 32
    x = torch.zeros((b, hq * 32, w), dtype=torch.int32, device=plane.device)
    x[:, :h] = (plane != 0).to(torch.int32)
    x = x.view(b, hq, 32, w)
    out = torch.zeros((b, hq, w), dtype=torch.int32, device=plane.device)
    for k in range(32):
        out |= x[:, :, k] << k
    return out


def unpack_rows_plain(words: torch.Tensor, h: int) -> torch.Tensor:
    """int32 [B,Hq,W] -> bool [B,h,W]."""
    b, hq, w = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None, :] >> shifts.view(1, 1, 32, 1)) & 1
    return bits.reshape(b, hq * 32, w)[:, :h].to(torch.bool)


def pack_rows_cuda(plane: torch.Tensor) -> torch.Tensor:
    expect(plane, "plane", (torch.bool, torch.uint8), 3)
    b, h, w = plane.shape
    out = torch.empty((b, (h + 31) // 32, w), dtype=torch.int32,
                      device=plane.device)
    _build.launch("pft_pack_rows", plane, plane.data_ptr(), out.data_ptr(),
                  b, h, w)
    launches["pack_rows"] += 1
    return out


def unpack_rows_cuda(words: torch.Tensor, h: int) -> torch.Tensor:
    expect(words, "words", (torch.int32,), 3)
    b, hq, w = words.shape
    if hq != (h + 31) // 32:
        raise ValueError(f"words have {hq} word rows; h={h} needs "
                         f"{(h + 31) // 32}")
    out = torch.empty((b, h, w), dtype=torch.bool, device=words.device)
    _build.launch("pft_unpack_rows", words, words.data_ptr(), out.data_ptr(),
                  b, h, w)
    launches["unpack_rows"] += 1
    return out


def pack_rows(plane: torch.Tensor) -> torch.Tensor:
    if use_kernel(plane):
        return pack_rows_cuda(plane)
    return pack_rows_plain(plane)


def unpack_rows(words: torch.Tensor, h: int) -> torch.Tensor:
    if use_kernel(words):
        return unpack_rows_cuda(words, h)
    return unpack_rows_plain(words, h)


# ------------------------------------------------------------ flood round

def _lanes(x: torch.Tensor, s: int) -> torch.Tensor:
    """out[..., i] = x[..., i - s] along W, zero fill (s may be < 0)."""
    out = torch.zeros_like(x)
    if s > 0:
        out[..., s:] = x[..., :-s]
    else:
        out[..., :s] = x[..., -s:]
    return out


def _words(x: torch.Tensor, s: int) -> torch.Tensor:
    """out[:, q] = x[:, q - s] along the word rows, zero fill."""
    if s == 0:
        return x
    out = torch.zeros_like(x)
    if s > 0:
        out[:, s:] = x[:, :-s]
    else:
        out[:, :s] = x[:, -s:]
    return out


def _rows_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """Packed row shift: bit-row y takes bit-row y - s."""
    q, t = divmod(s, 32)
    a = _words(x, q)
    if t == 0:
        return a
    return (a << t) | lsr(_words(x, q + 1), 32 - t)


def _rows_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """Packed row shift: bit-row y takes bit-row y + s."""
    q, t = divmod(s, 32)
    a = _words(x, -q)
    if t == 0:
        return a
    return lsr(a, t) | (_words(x, -q - 1) << (32 - t))


def _seg_or(r, m, n, fwd, bwd):
    """Doubling segmented OR: r |= any r in its run of m (both ways)."""
    a_f, a_b, s = m, m, 1
    while s < n:
        r = r | (a_f & fwd(r, s)) | (a_b & bwd(r, s))
        a_f = a_f & fwd(a_f, s)
        a_b = a_b & bwd(a_b, s)
        s *= 2
    return r & m


def flood_round_plain(m: torch.Tensor, r: torch.Tensor, leap: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One round on packed int32 [B,Hq,W] planes: seg-OR along W, seg-OR
    along H, Chebyshev dilation of radius `leap` gated by m. Returns the
    new state and the per-page count of changed words."""
    b, hq, w = m.shape
    t = _seg_or(r & m, m, w, _lanes, lambda x, s: _lanes(x, -s))
    t = _seg_or(t, m, hq * 32, _rows_down, _rows_up)
    d, c = t, 0
    while c < leap:
        s = min(max(c, 1), leap - c)
        d = d | _lanes(d, s) | _lanes(d, -s)
        c += s
    c = 0
    while c < leap:
        s = min(max(c, 1), leap - c)
        d = d | _rows_down(d, s) | _rows_up(d, s)
        c += s
    r2 = (d & m) | t
    return r2, (r2 != t).sum(dim=(1, 2), dtype=torch.int32)


def _flood(step, r: torch.Tensor, max_iters: int) -> torch.Tensor:
    """Rounds as the reference runs them: two, then more while the last
    one changed something and fewer than max_iters have run."""
    global last_info
    r, _ = step(r)
    r, changed = step(r)
    i = 2
    while i < max_iters and int(changed.sum()) > 0:
        r, changed = step(r)
        i += 1
    last_info = torch.tensor([0, 0, 0, i], dtype=torch.int32)
    return r


def _flood_args(seeds_w, mask_w, h, w, leap, max_iters) -> int:
    if leap < 1:
        raise ValueError(f"leap must be >= 1, got {leap}")
    if seeds_w.shape != mask_w.shape:
        raise ValueError(f"seeds {tuple(seeds_w.shape)} vs mask "
                         f"{tuple(mask_w.shape)}")
    return h * w + 2 if max_iters is None else max_iters


def flood_packed_plain(seeds_w: torch.Tensor, mask_w: torch.Tensor, h: int,
                       w: int, leap: int = 1, max_iters: int | None = None
                       ) -> torch.Tensor:
    max_iters = _flood_args(seeds_w, mask_w, h, w, leap, max_iters)
    return _flood(lambda r: flood_round_plain(mask_w, r, leap),
                  seeds_w & mask_w, max_iters)


def flood_packed_cuda(seeds_w: torch.Tensor, mask_w: torch.Tensor, h: int,
                      w: int, leap: int = 1, max_iters: int | None = None
                      ) -> torch.Tensor:
    """The whole flood in one cooperative launch: the rounds run on the
    card until one changes nothing (or `max_iters` have run), and the
    host reads nothing back. Scratch is allocated once a flood."""
    expect(mask_w, "mask", (torch.int32,), 3)
    expect(seeds_w, "seeds", (torch.int32,), 3)
    max_iters = _flood_args(seeds_w, mask_w, h, w, leap, max_iters)
    b, hq, wq = mask_w.shape
    if _build.host_size("pft_flood_packed_smem", hq, wq) > MAX_SHARED_BYTES:
        raise ValueError(
            f"h={h}, w={w}: the packed flood stages a packed row (w <= "
            f"{MAX_SHARED_BYTES // 12}) and a 32-column strip (h <= "
            f"{MAX_SHARED_BYTES // 384 * 32}) in shared memory")
    r = seeds_w & mask_w
    t, v = torch.empty_like(r), torch.empty_like(r)
    info = torch.zeros(4, dtype=torch.int32, device=r.device)
    # a leap past the page reaches nothing more; the cap keeps C ints
    _build.launch("pft_flood_packed", r, mask_w.data_ptr(), r.data_ptr(),
                  t.data_ptr(), v.data_ptr(), info.data_ptr(), b, hq, wq,
                  min(leap, max(h, wq)), min(max_iters, 2**31 - 1))
    launches["flood_round"] += 1
    global last_info
    last_info = info
    return r


def rounds_of_last_flood() -> int:
    """Rounds the last packed flood ran (reads the card after
    `flood_packed_cuda`: for measurement, not for the paths)."""
    return int(last_info[3])


def flood_packed(seeds_w: torch.Tensor, mask_w: torch.Tensor, h: int, w: int,
                 leap: int = 1, max_iters: int | None = None) -> torch.Tensor:
    """Exact 8-connected reach of the seeds through the mask, where mask
    pixels within Chebyshev distance `leap` count as connected. Packed
    int32 [B,Hq,W] in and out.

    max_iters=None caps the rounds at h*w + 2, a true bound: every round
    counted as changed grows the reach set, so the fixed point is always
    reached first."""
    if use_kernel(seeds_w, mask_w):
        return flood_packed_cuda(seeds_w, mask_w, h, w, leap, max_iters)
    return flood_packed_plain(seeds_w, mask_w, h, w, leap, max_iters)
