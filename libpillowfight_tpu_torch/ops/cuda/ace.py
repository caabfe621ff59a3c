"""ACE random-spray accumulation (kernel `csrc/ace_spray.cu`).

Replaces `libpillowfight_tpu/ops/pallas/ace_kernel.py` `_ace_tile_kernel`
(via `ace_spray_pallas`): samples shared by every pixel of a page.
"""

from __future__ import annotations

import torch

from ... import _build
from . import expect, use_kernel

launches = 0


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


def ace_spray_cuda(planar: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                   sval: torch.Tensor, slope: float, limit: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
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
    num = torch.empty_like(planar)
    invd = torch.empty((b, h, w), dtype=torch.float32, device=planar.device)
    _build.check(_build.load().pft_ace_spray(
        planar.data_ptr(), sy.data_ptr(), sx.data_ptr(), sval.data_ptr(),
        num.data_ptr(), invd.data_ptr(), b, h, w, s, float(slope),
        float(limit), _build.stream_of(planar)), "pft_ace_spray")
    global launches
    launches += 1
    return num, invd


def ace_spray(planar: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
              sval: torch.Tensor, slope: float, limit: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if use_kernel(planar, sy, sx, sval):
        return ace_spray_cuda(planar, sy, sx, sval, slope, limit)
    return ace_spray_plain(planar, sy, sx, sval, slope, limit)
