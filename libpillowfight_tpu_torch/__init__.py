"""PyTorch + CUDA port of libpillowfight_tpu (the unpaper cleanup chain,
gaussian, sobel, canny, ACE, SWT and compare).

The JAX package `libpillowfight_tpu` is the reference; this package
mirrors its layout and its top-level names and is held against it:
bit-identical for the cleanup chain, within the parity bars of ROADMAP.md
for the rest. It imports `torch` and never `jax`.

Two API surfaces, as in the reference:

* **Batched API** (`ops`, `run_pipeline`, `parallel.BatchRunner`):
  uint8 RGBA [B,H,W,4] or int32 word tensors.
* **Compatibility façade** (`compat`, and the `pillowfight_torch` shim):
  PIL.Image in and out, one call per image, on the first CUDA card
  unless the call passes `device=`. Page IO for the runner is `io`.

Every function takes its device from the input tensor: a CPU tensor runs
the plain PyTorch version of each kernel, a CUDA tensor launches the
hand-written Hopper kernels in `csrc/` (built with nvcc at first use).
"""

from . import compat, core, io, ops, parallel, utils
from .core.bitmap import compare
from .core.constants import (
    SWT_OUTPUT_BW_TEXT,
    SWT_OUTPUT_GRAYSCALE_TEXT,
    SWT_OUTPUT_ORIGINAL_BOXES,
)
from .ops import (
    ace,
    canny,
    gaussian,
    sobel,
    unpaper_blackfilter,
    unpaper_blurfilter,
    unpaper_border,
    unpaper_grayfilter,
    unpaper_masks,
    unpaper_noisefilter,
)
from .ops.swt import swt
from .parallel.pipeline import (DOCUMENT_CLEANUP, EDGE_STACK,
                                compile_pipeline, normalize_spec,
                                run_pipeline)
from .version import __version__, get_version

__all__ = [
    "compat", "core", "io", "ops", "parallel", "utils",
    "ace", "canny", "compare", "gaussian", "get_version", "sobel", "swt",
    "unpaper_blackfilter", "unpaper_blurfilter", "unpaper_border",
    "unpaper_grayfilter", "unpaper_masks", "unpaper_noisefilter",
    "SWT_OUTPUT_BW_TEXT", "SWT_OUTPUT_GRAYSCALE_TEXT",
    "SWT_OUTPUT_ORIGINAL_BOXES", "__version__",
    "DOCUMENT_CLEANUP", "EDGE_STACK", "compile_pipeline", "normalize_spec",
    "run_pipeline",
]
