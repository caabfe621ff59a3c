"""The plain reference of the benchmark's configurations: what a
configuration's spec computes, in plain PyTorch, on int32 RGBA words.

It imports nothing of the program and takes nothing the program made:
the benchmark hands it the same input pages it hands the program.
`ft` is the float type of the gray and gradient planes: float32 as the
configurations state it; a lower precision gives the control that the
comparison must fail. A filter that is neither an unpaper filter nor
swt is `reference/<filter>.py`'s `apply(words, ft=..., **params)`.
"""

from __future__ import annotations

import importlib

import torch

from . import unpaper
from .swt import swt


def run(words: torch.Tensor, spec, ft=torch.float32) -> torch.Tensor:
    """The spec's filters in order on int32 words [B,H,W]; the output
    words. spec: [[name, {param: value}], ...]."""
    for name, params in spec:
        if name in unpaper.FILTERS:
            words = unpaper.apply(words, name, params, ft)
        elif name == "swt":
            words = swt(words, ft=ft, **params)
        else:
            words = importlib.import_module(f"{__name__}.{name}").apply(
                words, ft=ft, **params)
    return words
