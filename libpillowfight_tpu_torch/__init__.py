"""PyTorch + CUDA port of libpillowfight_tpu (the unpaper cleanup chain,
gaussian, sobel, canny, ACE, SWT and compare).

The JAX package `libpillowfight_tpu` is the reference; this package
mirrors its layout and is held against it: bit-identical for the cleanup
chain, within the parity bars of ROADMAP.md for the rest. It imports
`torch` and never `jax`.

Every function takes its device from the input tensor: a CPU tensor runs
the plain PyTorch version of each kernel, a CUDA tensor launches the
hand-written Hopper kernels in `csrc/` (built with nvcc at first use).
"""

from .core.bitmap import compare
from .ops.ace import ace
from .ops.canny import canny
from .ops.gaussian import gaussian
from .ops.sobel import sobel
from .ops.swt import swt
from .parallel.pipeline import (DOCUMENT_CLEANUP, EDGE_STACK,
                                compile_pipeline, normalize_spec,
                                run_pipeline)

__all__ = ["DOCUMENT_CLEANUP", "EDGE_STACK", "ace", "canny",
           "compare", "compile_pipeline", "gaussian", "normalize_spec",
           "run_pipeline", "sobel", "swt"]
