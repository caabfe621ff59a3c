"""The unpaper scan-cleanup filters."""

from .blackfilter import unpaper_blackfilter
from .blurfilter import unpaper_blurfilter
from .border import unpaper_border
from .grayfilter import unpaper_grayfilter
from .masks import unpaper_masks
from .noisefilter import unpaper_noisefilter

__all__ = [
    "unpaper_blackfilter",
    "unpaper_blurfilter",
    "unpaper_border",
    "unpaper_grayfilter",
    "unpaper_masks",
    "unpaper_noisefilter",
]
