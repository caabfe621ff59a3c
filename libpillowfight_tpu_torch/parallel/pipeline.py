"""Filter pipelines (port of `libpillowfight_tpu/parallel/pipeline.py`).

A spec is a tuple of (filter_name, kwargs) pairs, the same spec the JAX
package takes. Consecutive unpaper filters run as one group on int32
words, threading two bool planes (dark, non-white) between the stages: a
wiped pixel becomes exactly white, so `plane & ~wipe` equals re-deriving
the plane from the wiped page. swt takes words or RGBA as they come;
every other filter runs on uint8 RGBA.

While a profiler runs, a call is the span `pipeline` (a request id of its
own, or its caller's), each filter the span `filter.<name>` (with the
stream time of its device work) and an unpaper group `unpaper.group`
(`utils.metrics.span`).
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..core import constants as C
from ..core.bitmap import (ensure_batched, maybe_unbatch, pages_to_words,
                           rgba_to_gray, wipe_white_words, words_to_gray,
                           words_to_pages, words_to_s3)
from ..ops.ace import ace
from ..ops.canny import canny
from ..ops.gaussian import gaussian
from ..ops.sobel import sobel
from ..ops.swt import swt
from ..ops.unpaper.blackfilter import blackfilter_wipe, blackfilter_wipe_dark
from ..ops.unpaper.blurfilter import blurfilter_wipe, blurfilter_wipe_nonwhite
from ..ops.unpaper.border import border_wipe, border_wipe_dark
from ..ops.unpaper.common import dark_mask, nonwhite_mask, wipe_white
from ..ops.unpaper.grayfilter import grayfilter_wipe, grayfilter_wipe_planes_s3
from ..ops.unpaper.masks import masks_wipe, masks_wipe_dark
from ..ops.unpaper.noisefilter import noisefilter_wipe, noisefilter_wipe_nonwhite
from ..utils.metrics import new_request, span
from .mesh import ShardedPages
from .spatial import run_unpaper_group
from .spatial_ace import sharded_ace
from .spatial_edges import sharded_canny, sharded_gaussian, sharded_sobel
from .spatial_swt import sharded_swt

# filters that run on uint8 RGBA pages (swt also takes int32 words and
# returns the form it was given)
_PAGE_FILTERS = {"ace": ace, "canny": canny, "gaussian": gaussian,
                 "sobel": sobel, "swt": swt}

# their counterparts on pages whose rows are sharded
_SHARDED_FILTERS = {"ace": sharded_ace, "canny": sharded_canny,
                    "gaussian": sharded_gaussian, "sobel": sharded_sobel,
                    "swt": sharded_swt}

# gray-plane wipe of each unpaper filter (the fallback path)
_WIPES = {
    "unpaper_blackfilter": blackfilter_wipe,
    "unpaper_noisefilter": noisefilter_wipe,
    "unpaper_blurfilter": blurfilter_wipe,
    "unpaper_grayfilter": grayfilter_wipe,
    "unpaper_masks": masks_wipe,
    "unpaper_border": border_wipe,
}

_FILTERS = sorted([*_WIPES, *_PAGE_FILTERS])

DOCUMENT_CLEANUP = (
    ("unpaper_blackfilter", ()),
    ("unpaper_noisefilter", ()),
    ("unpaper_blurfilter", ()),
    ("unpaper_masks", ()),
    ("unpaper_grayfilter", ()),
    ("unpaper_border", ()),
)

EDGE_STACK = (("canny", ()),)


def normalize_spec(spec: Iterable) -> tuple:
    """Canonicalize a spec to a hashable tuple of
    (name, ((kwarg, value), ...)) pairs."""
    out = []
    for item in spec:
        if isinstance(item, str):
            name, kwargs = item, ()
        else:
            name, kwargs = item
            if isinstance(kwargs, dict):
                kwargs = tuple(sorted(kwargs.items()))
            else:
                kwargs = tuple(kwargs)
        if name not in _FILTERS:
            raise ValueError(f"unknown filter {name!r}; have {_FILTERS}")
        out.append((name, kwargs))
    return tuple(out)


def _run_unpaper_group(words: torch.Tensor, group) -> torch.Tensor:
    """A run of unpaper filters on int32 words [B,H,W], by bool-plane
    threading."""
    gray0 = words_to_gray(words)
    dark0 = dark_mask(gray0)
    nonwhite0 = nonwhite_mask(gray0)
    del gray0
    acc = None  # union of the wipes so far

    def live(plane):
        return plane if acc is None else plane & ~acc

    for name, kwargs in group:
        kw = dict(kwargs)
        with span(f"filter.{name}", device=words):
            if name == "unpaper_blackfilter":
                kw.pop("black_threshold", None)  # the default: dark0 holds it
                wipe = blackfilter_wipe_dark(live(dark0), **kw)
            elif name == "unpaper_noisefilter":
                wipe = noisefilter_wipe_nonwhite(live(nonwhite0), **kw)
            elif name == "unpaper_blurfilter":
                wipe = blurfilter_wipe_nonwhite(live(nonwhite0), **kw)
            elif name == "unpaper_masks":
                wipe = masks_wipe_dark(live(dark0), **kw)
            elif name == "unpaper_grayfilter":
                s3 = words_to_s3(words)  # a wiped pixel is white: s3 = 765
                if acc is not None:
                    s3 = torch.where(acc, 765, s3)
                wipe = grayfilter_wipe_planes_s3(live(dark0), s3, **kw)
            else:  # unpaper_border
                wipe = border_wipe_dark(live(dark0), **kw)
            acc = wipe if acc is None else acc | wipe
    return wipe_white_words(words, acc)


def _run_unpaper_group_gray(pages: torch.Tensor, group) -> torch.Tensor:
    """Gray-plane threading, for a non-default blackfilter
    black_threshold. uint8 RGBA in and out."""
    gray = rgba_to_gray(pages)
    acc = None
    for name, kwargs in group:
        with span(f"filter.{name}", device=pages):
            wipe = _WIPES[name](gray, **dict(kwargs))
            gray = torch.where(wipe, 255.0, gray)
            acc = wipe if acc is None else acc | wipe
    return wipe_white(pages, acc)


def _default_black_threshold(group) -> bool:
    return all(dict(kwargs).get("black_threshold",
                                C.UNPAPER_BLACK_THRESHOLD)
               == C.UNPAPER_BLACK_THRESHOLD
               for name, kwargs in group if name == "unpaper_blackfilter")


def _run_sharded(x: ShardedPages, spec: tuple) -> ShardedPages:
    """The spec on a batch placed by `shard_pages`. With one row shard a
    page, each shard runs the whole spec on its device. With more, the
    spec is walked as `run_pipeline` walks it: a run of unpaper filters
    goes to `spatial.run_unpaper_group`, every other filter to its
    rows-sharded function, and the conversions between words and pages
    are made shard by shard."""
    if x.shards.shape[1] == 1:
        return x.map(lambda s: run_pipeline(s, spec))
    in_words = x.dtype == torch.int32
    if not in_words and x.dtype != torch.uint8:
        raise TypeError(f"pages must be uint8 RGBA or int32 words, got "
                        f"{x.dtype}")
    i, n = 0, len(spec)
    while i < n:
        name, kwargs = spec[i]
        if name in _SHARDED_FILTERS:
            if x.dtype == torch.int32 and name != "swt":
                x = x.map(words_to_pages)
            with span(f"filter.{name}"):
                x = _SHARDED_FILTERS[name](x, **dict(kwargs))
            i += 1
            continue
        j = i
        while j < n and spec[j][0] in _WIPES:
            j += 1
        words = x if x.dtype == torch.int32 else x.map(pages_to_words)
        with span("unpaper.group"):
            x = run_unpaper_group(words, spec[i:j])
        i = j
    if not in_words and x.dtype == torch.int32:
        x = x.map(words_to_pages)
    elif in_words and x.dtype == torch.uint8:
        x = x.map(pages_to_words)
    return x


def run_pipeline(pages, spec: tuple):
    """Apply a normalized spec. Takes uint8 RGBA [B,H,W,4] or int32 words
    [B,H,W] (or one page) and returns the same form, on the input's
    device. A run of unpaper filters works on words, swt on either form,
    any other filter on RGBA, converted to before it and back at the
    end. A ShardedPages (`mesh.shard_pages`) gives a ShardedPages."""
    with span("pipeline", request=new_request()):
        if isinstance(pages, ShardedPages):
            return _run_sharded(pages, spec)
        return _run_pages(pages, spec)


def _run_pages(pages, spec: tuple):
    """`run_pipeline` on a tensor."""
    x, unb = ensure_batched(pages)
    in_words = x.dtype == torch.int32
    if not in_words and x.dtype != torch.uint8:
        raise TypeError(f"pages must be uint8 RGBA or int32 words, got "
                        f"{x.dtype}")
    i, n = 0, len(spec)
    while i < n:
        name, kwargs = spec[i]
        if name in _PAGE_FILTERS:
            if x.dtype == torch.int32 and name != "swt":
                x = words_to_pages(x)
            with span(f"filter.{name}", device=x):
                x = _PAGE_FILTERS[name](x, **dict(kwargs))
            i += 1
            continue
        j = i
        while j < n and spec[j][0] in _WIPES:
            j += 1
        group = spec[i:j]
        words = x if x.dtype == torch.int32 else pages_to_words(x)
        with span("unpaper.group", device=words):
            if _default_black_threshold(group):
                x = _run_unpaper_group(words, group)
            else:
                x = pages_to_words(
                    _run_unpaper_group_gray(words_to_pages(words), group))
        i = j
    if in_words and x.dtype == torch.uint8:
        x = pages_to_words(x)
    elif not in_words and x.dtype == torch.int32:
        x = words_to_pages(x)
    return maybe_unbatch(x, unb)


def compile_pipeline(spec: Iterable):
    """Return fn(pages) for the given spec (PyTorch runs eagerly: this
    only normalizes the spec once)."""
    spec = normalize_spec(spec)
    return lambda pages: run_pipeline(pages, spec)
