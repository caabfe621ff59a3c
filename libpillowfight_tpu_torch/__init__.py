"""PyTorch + CUDA port of libpillowfight_tpu (the unpaper cleanup chain).

The JAX package `libpillowfight_tpu` is the reference; this package
mirrors its layout and is held to bit-identical output against it.
It imports `torch` and never `jax`.

Every function takes its device from the input tensor: a CPU tensor runs
the plain PyTorch version of each kernel, a CUDA tensor launches the
hand-written Hopper kernels in `csrc/` (built with nvcc at first use).
"""

from .parallel.pipeline import (DOCUMENT_CLEANUP, compile_pipeline,
                                normalize_spec, run_pipeline)

__all__ = ["DOCUMENT_CLEANUP", "compile_pipeline", "normalize_spec",
           "run_pipeline"]
