"""Filters of the port (unpaper, gaussian, sobel, canny, ACE) and their
kernels. Re-exports the names of `libpillowfight_tpu.ops`; as there, the
functions `ace`, `canny`, `gaussian` and `sobel` shadow their modules
(reach a module with `importlib.import_module`)."""

from .ace import ace, ace_with_samples
from .canny import canny, canny_edge_mask
from .gaussian import gaussian, gaussian_on_matrix
from .sobel import GradientMatrixes, sobel, sobel_on_matrix
from .unpaper import (
    unpaper_blackfilter,
    unpaper_blurfilter,
    unpaper_border,
    unpaper_grayfilter,
    unpaper_masks,
    unpaper_noisefilter,
)

__all__ = [
    "ace",
    "ace_with_samples",
    "canny",
    "canny_edge_mask",
    "gaussian",
    "gaussian_on_matrix",
    "GradientMatrixes",
    "sobel",
    "sobel_on_matrix",
    "unpaper_blackfilter",
    "unpaper_blurfilter",
    "unpaper_border",
    "unpaper_grayfilter",
    "unpaper_masks",
    "unpaper_noisefilter",
]
