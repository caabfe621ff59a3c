"""Noisefilter ball sweeps (kernels in `csrc/noise_cert.cu`): the
certificate sweep with the certificate + flood formulation of the
small-cluster mask, and the direct ball count.

Replaces `libpillowfight_tpu/ops/pallas/noise_kernel.py`
`_cert_band_kernel` (via `_cert_sweep`), `_noise_band_kernel` (via
`_noise_sweep` and `_ball_sweep`) and the orchestration of
`small_cluster_mask_pallas`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _build
from . import expect, use_kernel
from .flood_packed import flood_packed, lsr, pack_rows_plain, unpack_rows

# launch counts of the kernel wrappers
launches = {"noise_cert": 0, "noise_ball": 0}

MAX_J = 8   # certificate board radius the kernel is instantiated for (k <= 15)
MAX_K = 15  # ball radius the direct-count kernel is instantiated for


def _i32(v: int) -> int:
    """A uint32 bit pattern as the int32 of the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _board_words(j: int, skip: int | None) -> list[int]:
    """Words of the (2j+1)^2-bit board: bits b with b % s != skip."""
    s = 2 * j + 1
    nb = s * s
    out = []
    for w in range((nb + 31) // 32):
        v = 0
        for bit in range(32):
            b = w * 32 + bit
            if b < nb and (skip is None or b % s != skip):
                v |= 1 << bit
        out.append(_i32(v))
    return out


def _shift_board(words: list, amt: int) -> list:
    """Shift a multi-word board by amt bits (0 < |amt| < 32), zero fill."""
    nw, a = len(words), abs(amt)
    out = []
    for w in range(nw):
        if amt > 0:
            v = words[w] << a
            if w > 0:
                v = v | lsr(words[w - 1], 32 - a)
        else:
            v = lsr(words[w], a)
            if w + 1 < nw:
                v = v | (words[w + 1] << (32 - a))
        out.append(v)
    return out


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 bit patterns."""
    v = v - (lsr(v, 1) & 0x55555555)
    v = (v & 0x33333333) + (lsr(v, 2) & 0x33333333)
    v = (v + lsr(v, 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def _ball_sizes(plane: torch.Tensor, j: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(centre bool [B,H,W], |ball| int32 [B,H,W]): the size of each
    pixel's radius-j graph ball inside its (2j+1)^2 window, after j
    dilation steps on the window's bitboard; neighbours outside the page
    are 0. The plain version of both sweeps of `csrc/noise_cert.cu`."""
    b, h, w = plane.shape
    s = 2 * j + 1
    nw = (s * s + 31) // 32
    center = plane.to(torch.bool)
    mp = F.pad(center.to(torch.int32), (j, j, j, j))
    # hstrip[y, x] bit dx+j = mask[y - j, x + dx] (rows still padded)
    hstrip = torch.zeros((b, h + 2 * j, w), dtype=torch.int32,
                         device=plane.device)
    for dx in range(-j, j + 1):
        hstrip |= mp[:, :, j + dx: j + dx + w] << (dx + j)
    m = [torch.zeros((b, h, w), dtype=torch.int32, device=plane.device)
         for _ in range(nw)]
    for d in range(s):
        strip = hstrip[:, d: d + h]
        wi, o = divmod(d * s, 32)
        m[wi] = m[wi] | (strip << o)
        if o + s > 32 and wi + 1 < nw:
            m[wi + 1] = m[wi + 1] | lsr(strip, 32 - o)
    board = _board_words(j, None)
    val_p = _board_words(j, 0)
    val_m = _board_words(j, s - 1)
    cw, co = divmod(j * s + j, 32)
    zero = torch.zeros((b, h, w), dtype=torch.int32, device=plane.device)
    r = [torch.where(center, _i32(1 << co), 0).to(torch.int32) if wi == cw
         else zero for wi in range(nw)]
    for _ in range(j):
        sp = _shift_board(r, 1)
        sm = _shift_board(r, -1)
        t = [r[i] | (sp[i] & val_p[i]) | (sm[i] & val_m[i]) for i in range(nw)]
        up = _shift_board(t, s)
        dn = _shift_board(t, -s)
        r = [(t[i] | up[i] | dn[i]) & board[i] & m[i] for i in range(nw)]
    return center, sum(_popcount(x) for x in r)


def noise_cert_plain(plane: torch.Tensor, j: int, thresh: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed (cert, mask) int32 [B,ceil(H/32),W]: cert marks mask pixels
    whose radius-j graph ball in the (2j+1)^2 window has >= thresh
    members."""
    center, size = _ball_sizes(plane, j)
    return pack_rows_plain(center & (size >= thresh)), pack_rows_plain(center)


def noise_cert_cuda(plane: torch.Tensor, j: int, thresh: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    expect(plane, "plane", (torch.bool, torch.uint8), 3)
    if not 1 <= j <= MAX_J:
        raise ValueError(f"board radius j={j} outside 1..{MAX_J}")
    b, h, w = plane.shape
    shape = (b, (h + 31) // 32, w)
    cert = torch.empty(shape, dtype=torch.int32, device=plane.device)
    maskw = torch.empty(shape, dtype=torch.int32, device=plane.device)
    _build.launch("pft_noise_cert", plane, plane.data_ptr(), cert.data_ptr(),
                  maskw.data_ptr(), b, h, w, j, thresh)
    launches["noise_cert"] += 1
    return cert, maskw


def noise_cert(plane: torch.Tensor, j: int, thresh: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    if use_kernel(plane):
        return noise_cert_cuda(plane, j, thresh)
    return noise_cert_plain(plane, j, thresh)


def noise_ball_plain(plane: torch.Tensor, k: int) -> torch.Tensor:
    """bool [B,H,W]: mask pixels whose radius-k graph ball has <= k
    members, i.e. whose 8-connected cluster has <= k pixels."""
    center, size = _ball_sizes(plane, k)
    return center & (size <= k)


def noise_ball_cuda(plane: torch.Tensor, k: int) -> torch.Tensor:
    expect(plane, "plane", (torch.bool, torch.uint8), 3)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ball radius k={k} outside 1..{MAX_K}")
    b, h, w = plane.shape
    small = torch.empty((b, h, w), dtype=torch.bool, device=plane.device)
    _build.launch("pft_noise_ball", plane, plane.data_ptr(), small.data_ptr(),
                  b, h, w, k)
    launches["noise_ball"] += 1
    return small


def noise_ball(plane: torch.Tensor, k: int) -> torch.Tensor:
    """Pixels of 8-connected clusters with <= k members (1 <= k <= 15),
    by the direct ball count."""
    if use_kernel(plane):
        return noise_ball_cuda(plane, k)
    return noise_ball_plain(plane, k)


def small_cluster_mask_cert(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Pixels of 8-connected clusters with <= k members, bool [B,H,W].

    Every cluster of >= k+1 pixels holds a pixel whose radius-ceil(k/2)
    graph ball has >= k+1 members (a connected (k+1)-subtree has
    diameter <= k, so its centre reaches all of it in ceil(k/2) steps);
    a cluster of <= k pixels never does. So the packed flood from those
    certificates reaches exactly the big clusters. Exact for every k >= 1
    (the flood has no size limit here); the kernel takes k <= 15."""
    b, h, w = mask.shape
    certw, maskw = noise_cert(mask, (k + 1) // 2, k + 1)
    big = unpack_rows(flood_packed(certw, maskw, h, w, leap=1), h)
    return mask & ~big
