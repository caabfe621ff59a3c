"""SWT on pages whose rows are sharded over devices.

The reference has no module for this: GSPMD partitions `swt` over a
(pages, rows) mesh. Here each row shard runs the port's SWT stages, with
their kernels, and the result is the unsharded one bit for bit (see the
note on the sums below). Two passes:

**The width maps on a slab.** The canny stack (`spatial_edges.canny_rows`)
gives each shard its rows of the edges and the smoothed gradients. A
shard's maps come from a slab of its own rows plus `swt_halo(max_len)`
rows above and below (cut at the page's ends, where the unsharded maps
see the page end too), cropped after. The halo is what a pixel's map
reads, derived from `_VECS`, `_t_units` and `_MED_SAMPLES`:

* a first-edge chain is used only up to `_t_units(k)` steps, and a chain
  is exact whenever those steps lie in the slab: R = max_k t_units(k) *
  |dy_k| rows (`max_len` rows, the (1, 0) class);
* pass 2 clamps a pixel by the median pulled from its anchor, up to R
  rows away, plus one row for a knight's half cell;
* the median at an anchor reads its first 13 ray cells, up to
  (_MED_SAMPLES - 1) * 2 rows on the knight classes, and each of those
  cells' widths reads R rows and a half cell more;

so `halo = 2 R + (_MED_SAMPLES - 1) * 2 + 2`: 282 rows at the default
max_len of 128. A halo taller than a shard takes rows from as many
neighbours as it spans (`row_slab`).

**The letter pass on the shard's own rows.**

* The polarity comes from the page's median gray, from the shards'
  histograms summed.
* The links come from a slab of the shard's rows plus one row below;
  the label kernel labels the shard's own rows, and each local
  least-index label l becomes l + row0 * W.
* The components that cross a boundary are merged by the (1, 0), (1, 1)
  and (1, -1) links between the last row of one shard and the first of
  the next (the same ratio and polarity test as unsharded), with a min
  iterated to a fixed point (a component may cross many boundaries): the
  page's least-index labels, exactly. `merged_labels` holds the count
  of labels each page column's merge changed.
* The row runs and the `max_runs` cap: a run's rank on the page is its
  rank in the shard plus the runs of the shards above.
* The component tables (count, sums of the width and its square in
  float64, the box extremes in page coordinates, the polarity) are
  merged by label on the page column's first device and decided once
  (`ops.swt._decide`); the letters kept and the boxes go back to every
  shard, which draws its own rows of the boxes.

`max_runs` and `max_letters` default from the page's H * W. The float64
partial sums are added in another order than the unsharded `index_add_`:
the counts and the width sums are exact (whole numbers; widths >= 1 on a
grid of 2^-23 below 2^29), the squares round in float64 before the sum
is rounded to float32, the same order-independence the unsharded path
relies on for its atomics on a card (`ops/swt.py`).

While a profiler runs, each host read of the letter pass is the span
`sync.spatial_swt_<site>` (`utils.metrics.span`).
"""

from __future__ import annotations

import torch

from ..core import constants as C
from ..core.bitmap import pages_to_words, words_to_gray, words_to_pages
from ..ops.cuda.label import OFFSETS
from ..ops.morph import label_components_links
from ..ops.swt import (_MED_SAMPLES, _VECS, _boxes_on_mask,
                       _component_table, _decide, _gray_hist, _halves,
                       _letter_links, _letter_select, _median_from_hist,
                       _run_starts, _t_units, _within_run_cap, caps,
                       check_args, compose, swt_maps)
from ..utils.metrics import span
from .mesh import ShardedPages, device_scope
from .spatial import Column, across, map_columns
from .spatial_edges import canny_rows

# labels changed by the boundary merge of each page column of the last
# call of `sharded_swt`
merged_labels: list[int] = []

_SUMS = ("cnt", "s1", "s2")
_EXTREMES = (("ymin", "amin"), ("ymax", "amax"), ("xmin", "amin"),
             ("xmax", "amax"), ("neg", "amax"))


def swt_halo(max_len: int) -> int:
    """Rows above and below a shard that its width maps read (see the
    module's docstring)."""
    reach = max(_t_units(k, max_len) * abs(v[0]) for k, v in enumerate(_VECS))
    median = (_MED_SAMPLES - 1) * max(abs(v[0]) for v in _VECS)
    half = max(abs(c[0]) for v in _VECS for c in _halves(v))
    return 2 * reach + median + 2 * half


def _width_maps(col: Column, edges, gx, gy, max_len: int):
    """Each shard's (swt_minus, swt_plus) of its own rows."""
    halo = swt_halo(max_len)
    both = col.slab_op(
        [edges, gx, gy],
        lambda o, h: (max(o - halo, 0), min(o + h + halo, col.h)),
        lambda e, a, b: torch.cat(swt_maps(e, a, b, max_len)[:2]))
    return [m.chunk(2) for m in both]


def _merge_labels(ka: torch.Tensor, kb: torch.Tensor):
    """(keys, their component's least key) of the label pairs (ka[i],
    kb[i]): a min iterated along the pairs, with pointer jumping, to the
    fixed point."""
    keys, inv = torch.unique(torch.cat([ka, kb]), return_inverse=True)
    ia, ib = inv[:ka.numel()], inv[ka.numel():]
    rep = torch.arange(keys.numel(), device=keys.device)
    while True:
        new = rep.clone()
        new.scatter_reduce_(0, ia, rep[ib], "amin")
        new.scatter_reduce_(0, ib, rep[ia], "amin")
        new = new[new]
        if torch.equal(new, rep):
            return keys, keys[rep]
        rep = new


def _page_labels(col: Column, valid, links, n: int, w: int) -> list:
    """The page's least-index labels of each shard's own rows (n on the
    background): the label kernel on the shard's rows (the links of its
    last row, which reach the next shard, leave its plane and are
    dropped), offset to page indices, then the components that cross a
    boundary merged by those links."""
    lab = []
    for j, (v, ln) in enumerate(zip(valid, links)):
        with device_scope(v.device):
            own = {d: ln[..., k] for k, d in enumerate(OFFSETS)}
            lab.append(torch.where(v, label_components_links(v, own)
                                   + col.rows(j)[0] * w, n))
    dev0 = lab[0].device
    page = torch.arange(lab[0].shape[0], dtype=torch.int64)[:, None] * n
    ka, kb = [], []
    for j in range(len(lab) - 1):
        dev = lab[j].device
        last = lab[j][:, -1].to(torch.int64) + page.to(dev)
        first = lab[j + 1][:, 0].to(dev).to(torch.int64) + page.to(dev)
        for k, (dy, dx) in enumerate(OFFSETS):
            if dy == 1:  # (y, x) of the last row to (y + 1, x + dx)
                link = links[j][:, -1, :, k]
                with span("sync.spatial_swt_links"):  # masked indexing
                    ka.append(last[link].to(dev0))
                    kb.append(torch.roll(first, -dx, dims=-1)[link]
                              .to(dev0))
    ka = torch.cat(ka) if ka else torch.zeros(0, dtype=torch.int64)
    if ka.numel() == 0:
        merged_labels.append(0)
        return lab
    with span("sync.spatial_swt_merge"):
        keys, least = _merge_labels(ka, torch.cat(kb))
        merged_labels.append(int((keys != least).sum()))
    out = []
    for v, lb in zip(valid, lab):
        dev = lb.device
        ks, ls = keys.to(dev), least.to(dev)
        off = page.view(-1, 1, 1).to(dev)
        key = lb.to(torch.int64) + off
        pos = torch.searchsorted(ks, key.flatten()).clamp(
            max=ks.numel() - 1).view(key.shape)
        hit = (ks[pos] == key) & v
        out.append((torch.where(hit, ls[pos], key) - off).to(torch.int32))
    return out


def _merge_tables(parts: list, dev) -> tuple:
    """One page's component table from its shards' (labels, table)."""
    with span("sync.spatial_swt_tables"):
        comp, inv = torch.unique(torch.cat([c.to(dev) for c, _ in parts]),
                                 return_inverse=True)
    nc = comp.numel()
    table = {}
    for key in _SUMS:
        table[key] = torch.zeros(nc, dtype=torch.float64, device=dev) \
            .index_add_(0, inv, torch.cat([t[key].to(dev) for _, t in parts]))
    for key, how in _EXTREMES:
        table[key] = torch.zeros(nc, dtype=torch.int64, device=dev) \
            .scatter_reduce_(0, inv, torch.cat([t[key].to(dev)
                                                for _, t in parts]),
                             how, include_self=False)
    return comp, table


def _letters(col: Column, gray, minus, plus, max_letters: int,
             max_runs: int):
    """Each shard's letter mask of its own rows and the page column's
    (boxes, boxes_ok) of each page."""
    h_page, w = col.h, gray[0].shape[-1]
    n = h_page * w
    hist = across([_gray_hist(g) for g in gray], torch.add)
    med = [_median_from_hist(t, n)[:, None, None] for t in hist]
    swt, valid, neg = zip(*(_letter_select(*a) for a in zip(gray, minus,
                                                            plus, med)))
    # [b, h, W, 4] in `OFFSETS` order, from a slab of one more row: the
    # links of a shard's last row reach the next shard's first
    links = col.slab_op(
        [swt, valid, neg], lambda o, h: (o, min(o + h + 1, col.h)),
        lambda s, v, g: torch.stack(list(_letter_links(s, v, g).values()),
                                    dim=-1)[0])
    lab = _page_labels(col, valid, links, n, w)
    del links
    starts = [_run_starts(v, lb, n) for v, lb in zip(valid, lab)]
    with span("sync.spatial_swt_runs"):
        counts = torch.stack([s.sum(dim=(1, 2)).cpu()
                              for s in starts])  # [J,b], on the host
    before = counts.cumsum(0) - counts
    n_runs = counts.sum(0)
    dev0 = gray[0].device
    masks = [torch.zeros_like(v) for v in valid]
    boxes, boxes_ok = [], []
    for i in range(gray[0].shape[0]):
        parts = []
        for j in range(len(gray)):
            kept = valid[j][i]
            if int(n_runs[i]) > max_runs:  # the runs past the cap
                kept = kept & _within_run_cap(starts[j][i], max_runs,
                                              int(before[j, i]))
            parts.append(_component_table(lab[j][i], kept, swt[j][i],
                                          neg[j][i], row0=col.rows(j)[0]))
        comp, table = _merge_tables([(c, t) for c, _, _, t in parts], dev0)
        keep, bx, ok, _ = _decide(table, max_letters)
        for j, (c, inv, vidx, _) in enumerate(parts):
            dev = c.device
            mine = keep.to(dev)[torch.searchsorted(comp.to(dev), c)]
            masks[j][i].view(-1)[vidx] = mine[inv]
        boxes.append(bx)
        boxes_ok.append(ok)
    return masks, torch.stack(boxes), torch.stack(boxes_ok)


def _column(blocks: list, output_type: int, max_len: int, max_letters: int,
            max_runs: int) -> list:
    words = [p if p.dtype == torch.int32 else pages_to_words(p)
             for p in blocks]
    gray = [words_to_gray(wd) for wd in words]
    col = Column(gray)
    gx, gy, edges = canny_rows(gray)
    minus, plus = zip(*_width_maps(col, edges, gx, gy, max_len))
    del gx, gy, edges
    letter, boxes, boxes_ok = _letters(col, gray, minus, plus, max_letters,
                                       max_runs)
    out = []
    for j, (wd, g, m) in enumerate(zip(words, gray, letter)):
        o, h = col.rows(j)
        on_box = None
        if output_type == C.SWT_OUTPUT_ORIGINAL_BOXES:
            on_box = _boxes_on_mask(boxes.to(wd.device),
                                    boxes_ok.to(wd.device), col.h,
                                    wd.shape[-1], row0=o, n_rows=h)
        r = compose(wd, g, output_type, m, on_box)
        out.append(r if blocks[j].dtype == torch.int32 else
                   words_to_pages(r))
    return out


def sharded_swt(x: ShardedPages, output_type: int = C.SWT_OUTPUT_BW_TEXT,
                max_rays: int | None = None,
                max_len: int = C.SWT_MAX_RAY_LEN,
                max_letters: int | None = None, max_runs: int | None = None,
                max_edges: int | None = None,
                max_valid: int | None = None) -> ShardedPages:
    """`ops.swt` of uint8 RGBA pages or int32 words sharded over pages
    and rows; the same form out. max_rays and max_edges are accepted and
    ignored, as by `swt`."""
    del max_rays, max_edges
    check_args(output_type, max_len)
    max_letters, max_runs = caps(x.shape[1], x.shape[2], max_letters,
                                 max_runs, max_valid)
    merged_labels.clear()
    return map_columns(x, lambda blocks, _: _column(
        blocks, output_type, max_len, max_letters, max_runs))
