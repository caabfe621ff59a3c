"""The port's spans and counts (`utils.metrics.span`, `count`,
`recorded`) on the CPU.

With no profiler running nothing is recorded and the outputs are the
traced run's bit for bit. Under `torch.profiler` every span the CPU path
reaches is kept, nested in its parent's host interval, with its
request id, and appears as a `pft.*` range among the profiler's events;
the floods' round counts add up; the store is bounded.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libpillowfight_tpu_torch as pt
from libpillowfight_tpu_torch.ops import morph
from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
from libpillowfight_tpu_torch.ops.cuda import flood_sweep as fs
from libpillowfight_tpu_torch.parallel import BatchRunner
from libpillowfight_tpu_torch.utils import metrics
from libpillowfight_tpu_torch.utils.pages import synthetic_pages

torch.set_num_threads(1)

H, W = 80, 96
CHAIN = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
CHAIN_SWT = pt.normalize_spec(list(pt.DOCUMENT_CLEANUP) + [("swt", ())])
PAGES = synthetic_pages(4, H, W, seed=3)

RUNNER = {"runner.source", "runner.stage_in", "runner.issue",
          "runner.stage_out", "runner.wait_done", "runner.sink",
          "runner.manifest"}
CHAIN_SPANS = {"pipeline", "unpaper.group", "unpaper.block_stats", "flood",
               *(f"filter.{name}" for name, _ in CHAIN)}
SWT_SPANS = {"pipeline", "filter.swt", "swt.width_maps",
             "sync.swt_ray_medians", "sync.swt_gray_hist", "sync.swt_runs",
             "sync.swt_component_table", "sync.swt_letters",
             "sync.swt_nested"}


def _chain():
    return pt.run_pipeline(torch.from_numpy(PAGES[:2]), CHAIN).numpy()


def _swt():
    return pt.swt(torch.from_numpy(PAGES[:1])).numpy()


def _runner():
    out = np.zeros_like(PAGES)

    def sink(idx, pages):
        out[idx] = pages

    BatchRunner(CHAIN_SWT, chunk_size=2, devices=["cpu"]).run(
        len(PAGES), lambda idx: PAGES[idx], sink)
    return out


PATHS = {"chain": (_chain, CHAIN_SPANS),
         "swt": (_swt, SWT_SPANS - {"pipeline", "filter.swt"}),
         "runner": (_runner, RUNNER | CHAIN_SPANS | SWT_SPANS)}


def _traced(fn):
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, metrics.recorded(), prof


@pytest.mark.parametrize("path", list(PATHS))
def test_untraced_run_records_nothing_and_matches_traced(path):
    fn, _ = PATHS[path]
    metrics.clear()
    plain = fn()
    assert not metrics.tracing()
    rec = metrics.recorded()
    assert rec.spans == [] and rec.counts == [] and rec.dropped == 0
    traced, rec, _ = _traced(fn)
    assert rec.spans
    np.testing.assert_array_equal(traced, plain)


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_in_their_parents_and_share_requests(path):
    fn, want = PATHS[path]
    _, rec, prof = _traced(fn)
    names = Counter(s.name for s in rec.spans)
    assert want <= set(names), want - set(names)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.t0 <= s.t1 and s.device_s is None  # no card: no stream
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert parent.t0 <= s.t0 and s.t1 <= parent.t1
        assert parent.thread == s.thread
        if not s.name.startswith("runner."):
            assert s.request == parent.request
    tops = [s for s in rec.spans if s.parent is None]
    if path == "runner":
        # every span of a chunk carries the chunk's start index
        assert all(s.name in RUNNER for s in tops)
        assert {s.request for s in tops} == {0, 2}
        for s in rec.spans:
            top = s
            while top.parent is not None:
                top = by_id[top.parent]
            assert s.request == top.request
        # the runner's call on the mesh, then each shard's
        calls = {s.id: s.name for s in rec.spans
                 if s.name in ("runner.issue", "pipeline")}
        for s in rec.spans:
            if s.name == "pipeline":
                assert calls[s.parent] in ("runner.issue", "pipeline")
    elif path == "chain":
        (call,) = [s for s in tops]
        assert call.name == "pipeline" and call.request is not None
    # the same spans are the profiler's `pft.*` ranges, as the trace has
    # them (`prof.events()` folds a range into a same-named parent)
    ranges = Counter(e.name()[len("pft."):]
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("pft."))
    assert ranges == names


def test_pipeline_calls_take_requests_of_their_own():
    metrics.clear()
    x = torch.from_numpy(PAGES[:1])
    with profile(activities=[ProfilerActivity.CPU]):
        pt.run_pipeline(x, (("unpaper_border", ()),))
        pt.run_pipeline(x, (("unpaper_border", ()),))
    calls = [s for s in metrics.recorded().spans if s.name == "pipeline"]
    assert len(calls) == 2 and calls[0].request != calls[1].request


def _flood_case():
    rng = np.random.default_rng(7)
    mask = rng.random((2, 64, 72)) < 0.55
    mask[:, 10:12, :] = True
    seeds = np.zeros_like(mask)
    seeds[:, 11, 0] = True
    return torch.from_numpy(seeds), torch.from_numpy(mask)


def _packed_rounds(seeds, mask, leap):
    """Rounds the plain packed flood runs, counted apart: its steps."""
    seeds_w, mask_w = fp.pack_rows(seeds), fp.pack_rows(mask)
    rounds = 0

    def step(r):
        nonlocal rounds
        rounds += 1
        return fp.flood_round_plain(mask_w, r, leap)

    fp._flood(step, seeds_w & mask_w, 64 * 72 + 2)
    return rounds


def _sweep_rounds(seeds, mask, leap):
    """Rounds the plain sweep runs, counted apart: the fewest rounds that
    give the fixed point, and the round that finds nothing changed."""
    full = fs.flood_sweep_plain(seeds, mask, leap)
    k = 1
    while not torch.equal(fs.flood_sweep_plain(seeds, mask, leap, k), full):
        k += 1
    return k + 1


@pytest.mark.parametrize("route", ["packed", "sweep"])
def test_flood_rounds_are_counted_per_flood(route, monkeypatch):
    seeds, mask = _flood_case()
    if route == "sweep":
        monkeypatch.setattr(morph, "packed_fits", lambda h, w: False)
    want = []
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for leap in (1, 3):
            morph.flood_reach(seeds, mask, connectivity=8, leap=leap)
            count = _sweep_rounds if route == "sweep" else _packed_rounds
            want.append(count(seeds, mask, leap))
    kept = metrics._STORE.counts
    assert [c.name for c in kept] == ["flood.rounds"] * 2
    if route == "packed":
        # a view of the flood's count tensor, summed only when read
        assert all(isinstance(c.value, torch.Tensor) for c in kept)
    rec = metrics.recorded()
    floods = [s for s in rec.spans if s.name == "flood"]
    assert len(floods) == 2
    assert [c.parent for c in rec.counts] == [s.id for s in floods]
    assert [c.value for c in rec.counts] == want and min(want) >= 2


def test_packed_count_is_read_only_when_recorded():
    seeds, mask = _flood_case()
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        morph.flood_reach(seeds, mask, connectivity=8)
    fp.last_info[3] = 41  # what the card would hold when it is read
    assert [c.value for c in metrics.recorded().counts] == [41]


@pytest.mark.parametrize("kind", ["PnmPageSource", "ImagePageSource"])
def test_opening_a_page_source_is_a_span(kind, tmp_path):
    from libpillowfight_tpu_torch import io as tio

    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"p{i}.ppm"))
        tio.write_ppm(paths[-1], PAGES[i])
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with getattr(tio, kind)(paths, shape=(H, W)) as src:
            got = np.array(src(np.arange(2)))
    np.testing.assert_array_equal(got[..., :3], PAGES[:2, ..., :3])
    assert [s.name for s in metrics.recorded().spans] == ["io.open"]


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(metrics, "MAX_RECORDS", 5)
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(8):
            with metrics.span("s", request=i):
                metrics.count("c", i)
    rec = metrics.recorded()
    assert [s.request for s in rec.spans] == [0, 1, 2, 3, 4]
    assert [c.value for c in rec.counts] == [0, 1, 2, 3, 4]
    assert rec.dropped == 6
    metrics.clear()
    assert metrics.recorded().dropped == 0


def test_trace_clears_the_store_and_writes_pft_ranges(tmp_path, monkeypatch):
    import json
    import tempfile

    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("before"):
            pass
    assert metrics.recorded().spans
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with metrics.trace():  # the default directory: pf_trace in TMPDIR
        _chain()
    names = {s.name for s in metrics.recorded().spans}
    assert "before" not in names and CHAIN_SPANS <= names
    events = json.load(open(tmp_path / "pf_trace" / "trace.json"))
    ranges = {e["name"] for e in events["traceEvents"]
              if str(e.get("name", "")).startswith("pft.")}
    assert {f"pft.{n}" for n in CHAIN_SPANS} <= ranges


def test_spans_off_cost_nothing_but_a_shared_context():
    metrics.clear()
    assert not metrics.tracing()
    assert metrics.span("a") is metrics.span("b", request=3,
                                             device=torch.ones(1))
    assert metrics.new_request() is None
    metrics.count("c", torch.ones(1))
    assert metrics.recorded().counts == []
