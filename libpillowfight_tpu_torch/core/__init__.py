"""Core data model of the port: batched RGBA pages, gray planes, compare,
constants (the names of `libpillowfight_tpu.core`)."""

from . import constants
from .bitmap import (
    compare,
    ensure_batched,
    from_pil,
    gray_to_rgba,
    maybe_unbatch,
    normalize,
    rgba_to_gray,
    to_pil,
    to_uint8,
    write_ppm,
)

__all__ = [
    "constants",
    "compare",
    "ensure_batched",
    "from_pil",
    "gray_to_rgba",
    "maybe_unbatch",
    "normalize",
    "rgba_to_gray",
    "to_pil",
    "to_uint8",
    "write_ppm",
]
