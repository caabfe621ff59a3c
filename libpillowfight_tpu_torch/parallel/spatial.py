"""The unpaper group on pages whose rows are sharded over devices.

The reference has no module for this: GSPMD partitions its fused chain
over a (pages, rows) mesh. Here each row shard runs the port's decision
cores, with their kernels, on its own rows plus what its decisions need
from its neighbours, and the group's wipe is bit for bit the unsharded
group's (`pipeline._run_unpaper_group`):

* window statistics (the blackfilter's seeds, 20/5; the blurfilter,
  100/50 with neighbours d = size // step windows away; the grayfilter,
  50/20): a shard takes a slab of rows that starts on the page's window
  grid (anchored at page row 0) and holds every window covering one of
  its rows, and for the blurfilter those windows' neighbours. A window or
  a neighbour is then missing only where the page ends, as unsharded;
* the noisefilter: a cluster of at most k pixels spans at most k rows, so
  k + 1 halo rows decide the shard's own pixels exactly;
* the blackfilter's flood (8-connected, gaps up to `intensity` leapt):
  rounds in which a shard floods its rows plus `intensity` halo rows,
  seeded with what it and its neighbours reached there, until no shard's
  reach changes where a neighbour reads it. The flood is a monotone fixed
  point, so the result is the page's flood bit for bit;
* masks and border: the shards' dark counts (`line_counts`) make the
  page's row profile (concatenated) and column profile (summed; whole
  numbers in f32), and each shard cuts its rows out of the page's
  rectangles.

Planes are threaded as in `_run_unpaper_group`: each shard's dark and
non-white planes, the union of its wipes, the live planes after that;
halos carry the neighbours' live planes (and the grayfilter's s3 after
the wipes).

`Column` (a page column's row shards and its slab op), `flood`, `across`
(a page-wide min, max or sum over the shards) and `map_columns` serve
the other filters' rows-sharded modules too (`spatial_edges.py`,
`spatial_ace.py`, `spatial_swt.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.bitmap import wipe_white_words, words_to_gray, words_to_s3
from ..ops.morph import flood_reach
from ..ops.unpaper.blackfilter import blackfilter_seeds
from ..ops.unpaper.blurfilter import blurfilter_wipe_nonwhite
from ..ops.unpaper.border import border_wipe_profiles
from ..ops.unpaper.common import (_n_blocks, check_counts_domain, dark_mask,
                                  line_counts, nonwhite_mask)
from ..ops.unpaper.grayfilter import grayfilter_wipe_planes_s3
from ..ops.unpaper.masks import masks_wipe_profiles
from ..ops.unpaper.noisefilter import noisefilter_wipe_nonwhite
from ..utils.metrics import span
from .halo import row_slab
from .mesh import ShardedPages, device_scope

# exchange rounds of each flood of the last rows-sharded call (an unpaper
# group's blackfilter, canny's or swt's hysteresis), one entry a flood
# (page column by page column)
flood_rounds: list[int] = []


def _window_slab(o: int, h: int, page_h: int, size: int, step: int,
                 d: int = 0) -> tuple[int, int]:
    """Rows [lo, hi) that row shard [o, o+h) needs for the page's windows
    of `size` at `step`: lo on the page's window grid, every page window
    covering one of the shard's rows inside, with its neighbours d windows
    away. Every whole window of the slab is then a window of the page."""
    nb = _n_blocks(page_h, size, step)
    first = max((o - size) // step + 1 - d, 0)
    last = min((o + h - 1) // step + d, nb - 1)
    lo = min(first, o // step) * step
    return lo, (max(last * step + size, o + h) if last >= 0 else o + h)


class Column:
    """The row shards of one page column: their offsets and the slab op.
    blocks: any per-shard tensors [B, h_j, ...], top to bottom, each on
    its shard's device."""

    def __init__(self, blocks: list):
        self.blocks = blocks
        self.offs = np.cumsum([0] + [b.shape[1] for b in blocks]).tolist()
        self.h = self.offs[-1]

    def rows(self, j: int) -> tuple[int, int]:
        return self.offs[j], self.offs[j + 1] - self.offs[j]

    def slab_op(self, planes: list, window, core) -> list:
        """core(*slabs)[own rows] on each shard's device, where each slab
        holds rows window(o, h) of one plane of `planes` (a list a plane
        of per-shard tensors)."""
        out = []
        for j, b in enumerate(self.blocks):
            o, h = self.rows(j)
            lo, hi = window(o, h)
            with device_scope(b.device):
                slabs = [row_slab(p, lo, hi, b.device) for p in planes]
                out.append(core(*slabs)[:, o - lo: o - lo + h])
        return out

    def profile_op(self, dark: list, core, kw: dict) -> list:
        """core(page row counts, page column counts, row0=, n_rows=) for
        each shard's rows, from every shard's `line_counts`."""
        counts = []
        for d in dark:
            with device_scope(d.device):
                counts.append(line_counts(d))
        out = []
        for j, b in enumerate(self.blocks):
            o, h = self.rows(j)
            rows = torch.cat([r.to(b.device) for r, _ in counts], dim=1)
            cols = sum(c.to(b.device) for _, c in counts)
            out.append(core(rows, cols, **kw, row0=o, n_rows=h))
        return out


def across(parts: list, op) -> list:
    """op (`torch.minimum`, `torch.maximum`, `torch.add`) over the row
    shards' per-page values, one copy of the result on each shard's
    device. Exact for min and max, and for sums of whole numbers."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return [acc.to(p.device) for p in parts]


def flood(col: Column, seeds: list, mask: list, leap: int) -> list:
    """The page's 8-connected flood of `seeds` through `mask` (gaps up to
    `leap` leapt), by rounds of local floods over each shard's rows plus
    `leap` halo rows. A shard floods again only when a neighbour's reach
    changed inside its halo."""
    n = len(mask)
    halo = [(max(o - leap, 0), min(o + h + leap, col.h))
            for o, h in map(col.rows, range(n))]
    reach = [s & m for s, m in zip(seeds, mask)]
    dirty, rounds = list(range(n)), 0
    while dirty:
        rounds += 1
        new, spans = list(reach), []
        for j in dirty:
            (o, h), (lo, hi) = col.rows(j), halo[j]
            dev = mask[j].device
            with device_scope(dev):
                r = flood_reach(row_slab(reach, lo, hi, dev),
                                row_slab(mask, lo, hi, dev), connectivity=8,
                                leap=leap)[:, o - lo: o - lo + h]
            with span("sync.spatial_flood"):
                grew = (r != reach[j]).any(dim=2).any(dim=0).nonzero()
                if len(grew):
                    spans.append((j, o + int(grew[0]), o + int(grew[-1]) + 1))
            new[j] = r
        reach = new
        dirty = [j for j in range(n) if any(
            k != j and a < halo[j][1] and halo[j][0] < b for k, a, b in spans)]
    flood_rounds.append(rounds)
    return reach


def _blackfilter(col: Column, dark: list,
                 scan_size: int = C.BLACKFILTER_SCAN_SIZE,
                 scan_step: int = C.BLACKFILTER_SCAN_STEP,
                 scan_threshold: float = C.BLACKFILTER_SCAN_THRESHOLD,
                 intensity: int = C.BLACKFILTER_INTENSITY) -> list:
    check_counts_domain(col.h, scan_size, scan_step)
    seeds = col.slab_op(
        [dark], lambda o, h: _window_slab(o, h, col.h, scan_size, scan_step),
        lambda d: blackfilter_seeds(d, scan_size, scan_step, scan_threshold))
    return flood(col, seeds, dark, intensity)


def _noisefilter(col: Column, nonwhite: list,
                 intensity: int = C.NOISEFILTER_INTENSITY) -> list:
    halo = max(intensity, 0) + 1
    return col.slab_op(
        [nonwhite], lambda o, h: (max(o - halo, 0), min(o + h + halo, col.h)),
        lambda m: noisefilter_wipe_nonwhite(m, intensity))


def _blurfilter(col: Column, nonwhite: list, size: int = C.BLURFILTER_SIZE,
                step: int = C.BLURFILTER_STEP,
                intensity: float = C.BLURFILTER_INTENSITY) -> list:
    check_counts_domain(col.h, size, step)
    d = max(size // step, 1)
    return col.slab_op(
        [nonwhite], lambda o, h: _window_slab(o, h, col.h, size, step, d),
        lambda m: blurfilter_wipe_nonwhite(m, size, step, intensity))


def _grayfilter(col: Column, dark: list, s3: list,
                size: int = C.GRAYFILTER_SIZE, step: int = C.GRAYFILTER_STEP,
                threshold: float = C.GRAYFILTER_THRESHOLD) -> list:
    check_counts_domain(col.h, size, step)
    return col.slab_op(
        [dark, s3], lambda o, h: _window_slab(o, h, col.h, size, step),
        lambda d, s: grayfilter_wipe_planes_s3(d, s, size, step, threshold))


def _run_column(words: list, group) -> list:
    """The group on the int32 word row blocks of one page column."""
    col = Column(words)
    dark0, nonwhite0 = [], []
    for w in words:
        gray0 = words_to_gray(w)
        dark0.append(dark_mask(gray0))
        nonwhite0.append(nonwhite_mask(gray0))
    acc = [None] * len(words)  # union of each shard's wipes so far

    def live(planes):
        return [p if a is None else p & ~a for p, a in zip(planes, acc)]

    for name, kwargs in group:
        kw = dict(kwargs)
        with span(f"filter.{name}"):
            if name == "unpaper_blackfilter":
                thr = kw.pop("black_threshold", C.UNPAPER_BLACK_THRESHOLD)
                if thr == C.UNPAPER_BLACK_THRESHOLD:
                    dark = live(dark0)
                else:  # the gray-threaded path's plane: a wiped pixel is 255
                    dark = [dark_mask(words_to_gray(w) if a is None else
                                      torch.where(a, 255.0, words_to_gray(w)),
                                      thr) for w, a in zip(words, acc)]
                wipe = _blackfilter(col, dark, **kw)
            elif name == "unpaper_noisefilter":
                wipe = _noisefilter(col, live(nonwhite0), **kw)
            elif name == "unpaper_blurfilter":
                wipe = _blurfilter(col, live(nonwhite0), **kw)
            elif name == "unpaper_masks":
                wipe = col.profile_op(live(dark0), masks_wipe_profiles, kw)
            elif name == "unpaper_grayfilter":
                s3 = [words_to_s3(w) if a is None else
                      torch.where(a, 765, words_to_s3(w))
                      for w, a in zip(words, acc)]
                wipe = _grayfilter(col, live(dark0), s3, **kw)
            else:  # unpaper_border
                wipe = col.profile_op(live(dark0), border_wipe_profiles, kw)
            acc = [x if a is None else a | x for a, x in zip(acc, wipe)]
    return [wipe_white_words(w, a) for w, a in zip(words, acc)]


def map_columns(x: ShardedPages, fn) -> ShardedPages:
    """fn(row blocks of a page column, the column's first page) -> its
    output blocks, for every page column; `flood_rounds` cleared first."""
    flood_rounds.clear()
    out = np.empty_like(x.shards)
    for i, column in enumerate(x.shards):
        for j, block in enumerate(fn(list(column), x.page_offsets[i])):
            out[i, j] = block
    return ShardedPages(out, x.mesh)


def run_unpaper_group(words: ShardedPages, group) -> ShardedPages:
    """A run of unpaper filters on int32 words [B,H,W] sharded over pages
    and rows; bit-identical to the group on the gathered batch."""
    return map_columns(words, lambda column, _: _run_column(column, group))
