"""ACE random-spray accumulation (kernel `csrc/ace_spray.cu`).

Replaces `libpillowfight_tpu/ops/pallas/ace_kernel.py` `_ace_tile_kernel`
(via `ace_spray_pallas`): samples shared by every pixel of a page.
"""

from __future__ import annotations

import torch

from ... import _build
from . import expect, use_kernel

launches = 0

# The bar of the kernel against `ace_spray_plain`, in units of the largest
# possible magnitude of each output: every term |clip(.) * inv_d| is at
# most limit * inv_d, so |num| <= limit * invd, and invd is its own
# largest value. The kernel sums S terms in f32 in another form than the
# plain version (a saturating multiply-add in place of the clip, see
# `ace_spray_saturating`) and its rsqrt is ~2 ulp from torch's; both sums
# wander by a few sqrt(S) * 2^-24 of that magnitude, 1e-6 to 1e-5 of it for
# S up to 1000. The tests and the run on the card read this one number.
ACE_SPRAY_RTOL = 1e-5

# The kernel's shorter form (`prescaled`) is taken while |k| * 255 <= 2,
# k = slope / (2 limit): it rounds k I + 1/2 and k v apart, which costs
# 2^-24 * (|k I| + |k v| + 3/2) a term, 3.3e-7 of the bar's unit at the
# threshold for values in [0, 255].
PRESCALED_MAX_KI = 2.0


def ace_spray_plain(planar: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    sval: torch.Tensor, slope: float, limit: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """planar f32 [B,3,H,W]; sy/sx int [B,S]; sval f32 [B,3,S] ->
    (num f32 [B,3,H,W], invd f32 [B,H,W]):
      inv_d = min(rsqrt(max(dy^2 + dx^2, 1e-12)), 1)
      num_c = sum_s clip(slope * (I_c - v_c(s)), -limit, limit) * inv_d
      invd  = sum_s inv_d
    summed in sample order from 0."""
    b, _, h, w = planar.shape
    py = torch.arange(h, dtype=torch.float32, device=planar.device)
    px = torch.arange(w, dtype=torch.float32, device=planar.device)
    syf, sxf = sy.to(torch.float32), sx.to(torch.float32)
    num = torch.zeros_like(planar)
    invd = torch.zeros((b, h, w), dtype=torch.float32, device=planar.device)
    for s in range(sy.shape[1]):
        dy = py[None, :, None] - syf[:, s, None, None]  # [B,H,1]
        dx = px[None, None, :] - sxf[:, s, None, None]  # [B,1,W]
        d2 = dy * dy + dx * dx
        inv_d = torch.clamp(torch.rsqrt(torch.clamp(d2, min=1e-12)), max=1.0)
        delta = planar - sval[:, :, s, None, None]
        num += torch.clamp(slope * delta, -limit, limit) * inv_d[:, None]
        invd += inv_d
    return num, invd


def ace_spray_saturating(planar: torch.Tensor, sy: torch.Tensor,
                         sx: torch.Tensor, sval: torch.Tensor, slope: float,
                         limit: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`ace_spray_plain` in the kernel's arithmetic, for the tests: with
    k = slope / (2 limit) and u = clamp(k (I - v) + 1/2, 0, 1),
      clip(slope (I - v), -limit, limit) = limit (2u - 1),
    so num_c = limit (2 A_c - invd) with A_c = sum_s u_c * inv_d, in f32
    and in sample order; inv_d = rsqrt(max(d2, 1)), which equals the plain
    min(rsqrt(max(d2, 1e-12)), 1) because d2 is 0 or >= 1."""
    b, _, h, w = planar.shape
    k = torch.tensor(slope / (2.0 * limit), dtype=torch.float32,
                     device=planar.device)
    py = torch.arange(h, dtype=torch.float32, device=planar.device)
    px = torch.arange(w, dtype=torch.float32, device=planar.device)
    syf, sxf = sy.to(torch.float32), sx.to(torch.float32)
    acc = torch.zeros_like(planar)
    invd = torch.zeros((b, h, w), dtype=torch.float32, device=planar.device)
    for s in range(sy.shape[1]):
        dy = py[None, :, None] - syf[:, s, None, None]  # [B,H,1]
        dx = px[None, None, :] - sxf[:, s, None, None]  # [B,1,W]
        inv_d = torch.rsqrt(torch.clamp(dy * dy + dx * dx, min=1.0))
        u = torch.clamp(k * (planar - sval[:, :, s, None, None]) + 0.5,
                        0.0, 1.0)
        acc += u * inv_d[:, None]
        invd += inv_d
    return limit * (2.0 * acc - invd[:, None]), invd


def ace_spray_cuda(planar: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                   sval: torch.Tensor, slope: float, limit: float,
                   prescaled: bool | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel. `prescaled` picks the form of a channel's term (None:
    by `PRESCALED_MAX_KI`, for values in [0, 255])."""
    expect(planar, "planar", (torch.float32,), 4)
    expect(sy, "sy", (torch.int32,), 2)
    expect(sx, "sx", (torch.int32,), 2)
    expect(sval, "sval", (torch.float32,), 3)
    b, c, h, w = planar.shape
    s = sy.shape[1]
    if c != 3 or sx.shape != sy.shape or sy.shape[0] != b \
            or tuple(sval.shape) != (b, 3, s):
        raise ValueError(f"planar {tuple(planar.shape)}, sy "
                         f"{tuple(sy.shape)}, sx {tuple(sx.shape)}, sval "
                         f"{tuple(sval.shape)}")
    if b > 65535:
        raise ValueError(f"{b} pages: the kernel's grid takes <= 65535")
    if not limit > 0:
        raise ValueError(f"limit={limit}: the kernel takes limit > 0")
    if prescaled is None:
        prescaled = abs(slope) / (2.0 * limit) * 255.0 <= PRESCALED_MAX_KI
    num = torch.empty_like(planar)
    invd = torch.empty((b, h, w), dtype=torch.float32, device=planar.device)
    _build.launch("pft_ace_spray", planar, planar.data_ptr(), sy.data_ptr(),
                  sx.data_ptr(), sval.data_ptr(), num.data_ptr(),
                  invd.data_ptr(), b, h, w, s, float(slope), float(limit),
                  int(prescaled))
    global launches
    launches += 1
    return num, invd


def ace_spray(planar: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
              sval: torch.Tensor, slope: float, limit: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if use_kernel(planar, sy, sx, sval):
        return ace_spray_cuda(planar, sy, sx, sval, slope, limit)
    return ace_spray_plain(planar, sy, sx, sval, slope, limit)
