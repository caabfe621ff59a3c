"""pillowfight-compatible façade: PIL.Image in -> PIL.Image out (port of
`libpillowfight_tpu/compat.py`).

Drop-in replacement for the reference's Python API (ref:
src/pillowfight/__init__.py: `import pillowfight; pillowfight.ace(img)`
etc.). Every public function accepts a PIL.Image or a numpy uint8 array
(gray [H,W], RGB or RGBA [H,W,C]) and returns a PIL.Image, with the
reference's names, enums and defaults.

Each function also takes `device=`, keyword-only: None means the first
CUDA card, and with no card it raises RuntimeError (no silent fall back
to the CPU); pass `device="cpu"` to run the kernels' plain versions on
the CPU. The page goes to the device once and comes back once.

The device work of each function is a private function, numpy RGBA in
and numpy RGBA out (`_<name>_rgba`); the public function wraps it in
`to_pil`. So the same code runs where PIL is not installed.

For throughput, use the batched API (`libpillowfight_tpu_torch.ops`,
`run_pipeline`) on tensors: this façade pays a host <-> device round
trip per image, as the reference pays a PIL <-> bytes round trip per
call.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import bitmap
from .core import constants as C
from .ops import unpaper as _unpaper
from .ops.ace import ace as _ace
from .ops.canny import canny as _canny
from .ops.gaussian import gaussian as _gaussian
from .ops.sobel import sobel as _sobel
from .ops.swt import swt as _swt
from .version import get_version

SWT_OUTPUT_BW_TEXT = C.SWT_OUTPUT_BW_TEXT
SWT_OUTPUT_GRAYSCALE_TEXT = C.SWT_OUTPUT_GRAYSCALE_TEXT
SWT_OUTPUT_ORIGINAL_BOXES = C.SWT_OUTPUT_ORIGINAL_BOXES


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return torch.device("cuda", 0)


def _in(img) -> np.ndarray:
    """PIL.Image or numpy gray / RGB / RGBA -> uint8 RGBA [H,W,4] (host)."""
    if hasattr(img, "convert"):  # PIL.Image
        return bitmap.from_pil(img)
    arr = np.asarray(img)
    if arr.ndim == 2:  # gray -> RGBA
        arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        arr = np.concatenate(
            [arr, np.full(arr.shape[:2] + (1,), 255, arr.dtype)], axis=-1
        )
    return arr.astype(np.uint8)


def _on(device, fn, *pages: np.ndarray):
    """fn on the pages as tensors on `device`; tensors come back as host
    numpy."""
    dev = _device(device)
    # a PIL image's array is read-only; torch takes writable arrays only
    out = fn(*(torch.from_numpy(np.require(p, requirements=("C", "W"))).to(dev)
               for p in pages))
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy() for o in out)
    return out.cpu().numpy()


def _ace_rgba(rgba, slope=C.ACE_DEFAULT_SLOPE, limit=C.ACE_DEFAULT_LIMIT,
              samples=C.ACE_DEFAULT_NB_SAMPLES, seed=None, mode="rolled",
              device=None) -> np.ndarray:
    seed = C.ACE_DEFAULT_SEED if seed is None else int(seed)
    return _on(device, lambda x: _ace(
        x, nb_samples=int(samples), slope=float(slope), limit=float(limit),
        seed=seed, mode=mode), rgba)


def _canny_rgba(rgba, device=None) -> np.ndarray:
    return _on(device, _canny, rgba)


def _gaussian_rgba(rgba, sigma=C.GAUSSIAN_DEFAULT_SIGMA,
                   nb_stddev=C.GAUSSIAN_DEFAULT_NB_STDDEV,
                   device=None) -> np.ndarray:
    return _on(device, lambda x: _gaussian(x, float(sigma), int(nb_stddev)),
               rgba)


def _sobel_rgba(rgba, device=None) -> np.ndarray:
    return _on(device, _sobel, rgba)


def _swt_rgba(rgba, output_type=SWT_OUTPUT_BW_TEXT,
              device=None) -> np.ndarray:
    return _on(device, lambda x: _swt(x, output_type=int(output_type)), rgba)


def _compare_rgba(rgba, rgba2, tolerance=C.COMPARE_DEFAULT_TOLERANCE,
                  device=None) -> tuple[int, np.ndarray]:
    n, diff = _on(device, lambda a, b: bitmap.compare(
        a[None], b[None], tolerance=int(tolerance)), rgba, rgba2)
    return int(n[0]), diff[0]


def _unpaper_rgba(name: str, rgba, device=None) -> np.ndarray:
    return _on(device, getattr(_unpaper, name), rgba)


def ace(img, slope=C.ACE_DEFAULT_SLOPE, limit=C.ACE_DEFAULT_LIMIT,
        samples=C.ACE_DEFAULT_NB_SAMPLES, seed=None, mode="rolled", *,
        device=None):
    """ref: pillowfight.ace(img, slope=10, limit=1000, samples=100, seed=None).

    The default estimator is "rolled", as in the reference's façade:
    per-pixel sampling through shared random offsets. `seed=None` means
    `ACE_DEFAULT_SEED`, so a call is deterministic. mode="shared" is the
    single-spray approximation, the one that runs the spray kernel;
    mode="per_pixel" draws independent samples for every pixel."""
    return bitmap.to_pil(_ace_rgba(_in(img), slope, limit, samples, seed,
                                   mode, device=device))


def canny(img, *, device=None):
    return bitmap.to_pil(_canny_rgba(_in(img), device=device))


def gaussian(img, sigma=C.GAUSSIAN_DEFAULT_SIGMA,
             nb_stddev=C.GAUSSIAN_DEFAULT_NB_STDDEV, *, device=None):
    return bitmap.to_pil(_gaussian_rgba(_in(img), sigma, nb_stddev,
                                        device=device))


def sobel(img, *, device=None):
    return bitmap.to_pil(_sobel_rgba(_in(img), device=device))


def swt(img, output_type=SWT_OUTPUT_BW_TEXT, *, device=None):
    return bitmap.to_pil(_swt_rgba(_in(img), output_type, device=device))


def compare(img_in, img_in2, tolerance=C.COMPARE_DEFAULT_TOLERANCE, *,
            device=None):
    """ref: pillowfight.compare -> (nb_diff, diff PIL.Image)."""
    n, diff = _compare_rgba(_in(img_in), _in(img_in2), tolerance,
                            device=device)
    return n, bitmap.to_pil(diff)


def unpaper_blackfilter(img, *, device=None):
    return bitmap.to_pil(_unpaper_rgba("unpaper_blackfilter", _in(img),
                                       device=device))


def unpaper_blurfilter(img, *, device=None):
    return bitmap.to_pil(_unpaper_rgba("unpaper_blurfilter", _in(img),
                                       device=device))


def unpaper_border(img, *, device=None):
    return bitmap.to_pil(_unpaper_rgba("unpaper_border", _in(img),
                                       device=device))


def unpaper_grayfilter(img, *, device=None):
    return bitmap.to_pil(_unpaper_rgba("unpaper_grayfilter", _in(img),
                                       device=device))


def unpaper_masks(img, *, device=None):
    return bitmap.to_pil(_unpaper_rgba("unpaper_masks", _in(img),
                                       device=device))


def unpaper_noisefilter(img, *, device=None):
    return bitmap.to_pil(_unpaper_rgba("unpaper_noisefilter", _in(img),
                                       device=device))


__all__ = [
    "ace", "canny", "compare", "gaussian", "get_version", "sobel", "swt",
    "unpaper_blackfilter", "unpaper_blurfilter", "unpaper_border",
    "unpaper_grayfilter", "unpaper_masks", "unpaper_noisefilter",
    "SWT_OUTPUT_BW_TEXT", "SWT_OUTPUT_GRAYSCALE_TEXT",
    "SWT_OUTPUT_ORIGINAL_BOXES",
]
