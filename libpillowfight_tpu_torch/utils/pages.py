"""Synthetic scan-like pages, made from a seed with numpy.

`synthetic_pages` is the page the JAX package's `bench.py` times
(`bench._pages`), copied so that the port needs nothing of that file: a
black border, 3-px text lines, a gray block and 500 speckles. A test
holds the two byte-identical. `text_pages` adds letter-sized glyphs
(I, L and T shapes of 5-px strokes) between every other pair of text
lines, and closes the black border into a frame, so that SWT finds
letters on it: canny's thresholds are fractions of the page's strongest
gradient, and on a page that is light up to its rim that is the rim
itself (the blur and the gradient pad with zeros), twice as strong as
any glyph's edge.
"""

from __future__ import annotations

import numpy as np


def synthetic_pages(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """uint8 RGBA [b,h,w,4]: a scan-like page; every page of the batch
    is the same (the speckles are shared)."""
    rng = np.random.default_rng(seed)
    pages = np.full((b, h, w, 4), 245, np.uint8)
    pages[..., 3] = 255
    pages[:, :, : w // 40, :3] = 0
    for y in range(h // 10, h - h // 10, 40):
        pages[:, y: y + 3, w // 8: w - w // 8, :3] = 15
    pages[:, h // 2: h // 2 + h // 8, w // 10: w // 4, :3] = 190
    ys = rng.integers(0, h, 500)
    xs = rng.integers(w // 20, w, 500)
    pages[:, ys, xs, :3] = 30
    return pages


GLYPH_H, GLYPH_STROKE, GLYPH_PITCH = 24, 5, 40


def text_pages(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """`synthetic_pages` plus rows of glyphs: 24-px-high I, L and T shapes
    of 5-px strokes, one every 40 px, in every other gap between the text
    lines (about 1,600 letters on an A4 300 dpi page), inside a black
    frame as wide as the left border."""
    pages = synthetic_pages(b, h, w, seed)
    frame = w // 40
    pages[:, :frame, :, :3] = 0
    pages[:, h - frame:, :, :3] = 0
    pages[:, :, w - frame:, :3] = 0
    s, gh = GLYPH_STROKE, GLYPH_H
    for row, y in enumerate(range(h // 10, h - h // 10 - 40, 80)):
        top = y + 10
        for i, x in enumerate(range(w // 8 + 10, w - w // 8 - 20,
                                    GLYPH_PITCH)):
            kind = (i + row) % 3
            stem = x + (6 if kind == 2 else 0)
            pages[:, top: top + gh, stem: stem + s, :3] = 15
            if kind == 1:    # L: a foot to the right
                pages[:, top + gh - s: top + gh, x: x + 16, :3] = 15
            elif kind == 2:  # T: a bar across the top
                pages[:, top: top + s, x: x + 17, :3] = 15
    return pages
