"""The readers of the program's own spans and counts on synthetic
records whose numbers are known: clipping to the window, nothing read
where nothing was recorded, the outermost spans' stream time, and every
entry listing cells that exist."""

import pytest

from benchmark.harness import ROOT, Run, load_cell, load_json, load_module
from libpillowfight_tpu_torch.utils import metrics as pm

NEW = ("runner.device_wait_share", "runner.staging_ms_per_page",
       "pipeline.sync_wait_ms_per_page",
       "unpaper.block_stats_device_ms_per_page",
       "swt.width_maps_device_ms_per_page", "floods.rounds_per_flood")


def metric(name, run):
    return load_module("metrics", name).read(run)


def span(i, name, t0, t1, parent=None, device_s=None):
    return pm.SpanRecord(name, i, parent, 0, 1, t0, t1, device_s)


def synthetic(monkeypatch, spans, counts=()):
    """A 10 s window opening at t = 100 s, 4 pages; the program's records
    replaced by `spans` and `counts`."""
    records = pm.Records(sorted(spans, key=lambda s: s.t0), list(counts), 0)
    monkeypatch.setattr(pm, "recorded", lambda: records)
    return Run(cell=load_cell("ocr-prep-a4-300-files"), t_open=100.0,
               window_s=10.0, pages=4)


def test_runner_spans_are_clipped_to_the_window(monkeypatch):
    run = synthetic(monkeypatch, [
        span(1, "runner.wait_loaded", 99.0, 101.0),     # 1 s inside
        span(2, "runner.wait_done", 105.0, 106.0),
        span(3, "runner.wait_done", 109.5, 111.0),      # 0.5 s inside
        span(4, "runner.stage_in", 102.0, 102.004),
        span(5, "runner.stage_out", 103.0, 103.004),
        span(6, "runner.stage_in", 120.0, 121.0)])      # past the window
    assert metric("runner.device_wait_share", run) == pytest.approx(25.0)
    assert metric("runner.staging_ms_per_page", run) == pytest.approx(2.0)


def test_sync_wait_reads_zero_only_beside_pipeline_spans(monkeypatch):
    run = synthetic(monkeypatch, [
        span(1, "pipeline", 101.0, 103.0),
        span(2, "sync.swt_runs", 101.5, 101.502, parent=1),
        span(3, "sync.flood_sweep", 102.0, 102.006, parent=1),
        span(4, "syncopated", 102.0, 103.0, parent=1)])  # not a sync. span
    assert metric("pipeline.sync_wait_ms_per_page", run) == pytest.approx(2.0)
    run = synthetic(monkeypatch, [span(1, "pipeline", 101.0, 103.0)])
    assert metric("pipeline.sync_wait_ms_per_page", run) == 0.0


def test_stream_time_counts_outermost_spans_that_start_in_the_window(
        monkeypatch):
    run = synthetic(monkeypatch, [
        span(1, "filter.unpaper_blackfilter", 101.0, 102.0, device_s=0.5),
        span(2, "unpaper.block_stats", 101.1, 101.5, parent=1, device_s=0.2),
        span(3, "unpaper.block_stats", 101.2, 101.3, parent=2, device_s=0.1),
        span(4, "unpaper.block_stats", 101.6, 101.7, parent=1, device_s=0.1),
        span(5, "unpaper.block_stats", 99.0, 99.5, device_s=3.0),
        span(6, "swt.width_maps", 103.0, 104.0, device_s=0.3),
        span(7, "swt.width_maps", 109.9, 110.5, device_s=0.1)])
    # 0.2 + 0.1 s: the nested span is inside its parent's stream time
    assert metric("unpaper.block_stats_device_ms_per_page",
                  run) == pytest.approx(75.0)
    assert metric("swt.width_maps_device_ms_per_page",
                  run) == pytest.approx(100.0)


def test_stream_time_is_not_read_off_the_card(monkeypatch):
    run = synthetic(monkeypatch, [
        span(1, "unpaper.block_stats", 101.0, 101.5),
        span(2, "swt.width_maps", 102.0, 103.0)])
    assert metric("unpaper.block_stats_device_ms_per_page", run) is None
    assert metric("swt.width_maps_device_ms_per_page", run) is None


def test_rounds_per_flood(monkeypatch):
    spans = [span(1, "flood", 101.0, 101.1), span(2, "flood", 102.0, 102.1),
             span(3, "flood", 99.0, 99.1)]
    counts = [pm.CountRecord("flood.rounds", 3, 101.05, 1, 0),
              pm.CountRecord("flood.rounds", 4, 102.05, 2, 0),
              pm.CountRecord("flood.rounds", 50, 99.05, 3, 0)]
    run = synthetic(monkeypatch, spans, counts)
    assert metric("floods.rounds_per_flood", run) == pytest.approx(3.5)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, monkeypatch):
    run = synthetic(monkeypatch, [])
    assert metric(name, run) is None
    # spans outside the window only
    run = synthetic(monkeypatch, [span(1, n, 1.0, 2.0) for n in (
        "pipeline", "runner.wait_done", "runner.stage_in", "sync.swt_runs",
        "unpaper.block_stats", "swt.width_maps", "flood")])
    assert metric(name, run) is None
    # a program that keeps no records (a version before its spans)
    monkeypatch.delattr(pm, "recorded")
    assert metric(name, run) is None


def test_new_entries_list_only_cells_that_exist():
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"] for w in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert set(NEW) <= set(entries)
    layers = {m["layer"] for m in bench["per_layer"] if m["name"] not in NEW}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert m["layer"] in layers and m["moves"] == "pages_per_s"
        assert m["source"] in ("host_clock", "device_trace")
