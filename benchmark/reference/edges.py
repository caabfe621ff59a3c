"""The gradient stack that SWT reads: a separable Gaussian blur, Sobel
gradients and canny's edge mask, in plain PyTorch.

Every filter is an unrolled chain of shifted multiply-adds in row-major
tap order, zero taps skipped and the first term as the start value, so
that the sums round in libpillowfight's compiled reference's order;
`F.conv2d` is not used (cuDNN may take TF32, and sums in its own order).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .planes import flood

CANNY_SIGMA, CANNY_NB_STDDEV = 2.0, 5
CANNY_LOW, CANNY_HIGH = 0.47 / 2.0, 0.47   # fractions of the page's peak
SOBEL_GX = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                    np.float32)
SOBEL_GY = SOBEL_GX.T.copy()
_T1 = float(np.tan(np.pi / 8))
_T2 = float(np.tan(3 * np.pi / 8))


def _shift2(x, dy, dx):
    h, w = x.shape[-2:]
    py, px = abs(dy), abs(dx)
    p = F.pad(x, (px, px, py, py))
    return p[..., py + dy: py + dy + h, px + dx: px + dx + w]


def correlate(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Zero-padded same-size correlation of [..., H, W] with a 2-D
    kernel, taps cast to the plane's float type."""
    kh, kw = kernel.shape
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(kernel[i, j])
            if c == 0.0:
                continue
            term = _shift2(x, i - kh // 2, j - kw // 2)
            if c != 1.0:
                term = term * float(np.float32(c))
            out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(x)


def gaussian_taps(sigma: float, nb_stddev: int) -> np.ndarray:
    """Float32 taps, half-width ceil(sigma * nb_stddev), sum-normalized
    in float64."""
    hw = int(np.ceil(float(sigma) * int(nb_stddev)))
    xs = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.exp(-(xs ** 2) / (2.0 * float(sigma) ** 2))
    return np.asarray(k / k.sum(), np.float32)


def blur(x: torch.Tensor, sigma: float, nb_stddev: int) -> torch.Tensor:
    """Separable blur: along W, then along H."""
    k = gaussian_taps(sigma, nb_stddev)
    return correlate(correlate(x, k[None, :]), k[:, None])


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The larger leg times sqrt(1 + r^2), r the ratio of the legs."""
    x, y = x.abs(), y.abs()
    big, small = torch.maximum(x, y), torch.minimum(x, y)
    zero = big == 0
    r = small / torch.where(zero, torch.ones_like(big), big)
    out = torch.where(zero, big, big * torch.sqrt(1 + r * r))
    return torch.where(torch.isposinf(x) | torch.isposinf(y),
                       torch.full_like(out, float("inf")), out)


def normalize(m: torch.Tensor) -> torch.Tensor:
    """Per-page min-max rescale to [0, 255]; a flat page maps to 0."""
    lo = torch.amin(m, dim=(-2, -1), keepdim=True)
    hi = torch.amax(m, dim=(-2, -1), keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    return (m - lo) * (torch.full_like(span, 255.0) / span)


def gradients(gray: torch.Tensor) -> tuple:
    """(gx, gy) of the blurred page."""
    smoothed = blur(gray, CANNY_SIGMA, CANNY_NB_STDDEV)
    return correlate(smoothed, SOBEL_GX), correlate(smoothed, SOBEL_GY)


def _nms(intensity, gx, gy):
    """Non-maximum suppression in 4 direction bins."""
    ax, ay = gx.abs(), gy.abs()
    bin0 = ay <= _T1 * ax
    bin2 = ay >= _T2 * ax
    diag_pos = gx * gy > 0.0
    z = F.pad(intensity, (1, 1, 1, 1))
    h, w = intensity.shape[-2:]

    def shift(dy, dx):
        return z[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]

    diag_a = torch.where(diag_pos, shift(-1, 1), shift(-1, -1))
    diag_b = torch.where(diag_pos, shift(1, -1), shift(1, 1))
    a = torch.where(bin0, shift(0, 1), torch.where(bin2, shift(-1, 0), diag_a))
    b = torch.where(bin0, shift(0, -1), torch.where(bin2, shift(1, 0), diag_b))
    keep = (intensity >= a) & (intensity >= b)
    return torch.where(keep, intensity, torch.zeros_like(intensity))


def edge_mask(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Canny's edges from smoothed gradients: weak pixels of the double
    threshold 8-connected to a strong one."""
    nms = _nms(torch.round(normalize(hypot(gx, gy))), gx, gy)
    peak = torch.amax(nms, dim=(-2, -1), keepdim=True)
    live = nms > 0.0
    strong = (nms >= peak * CANNY_HIGH) & live
    weak = (nms >= peak * CANNY_LOW) & live
    return flood(strong, weak, leap=1)
