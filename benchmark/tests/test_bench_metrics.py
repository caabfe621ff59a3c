"""The metric readers and the trace's reduction on small synthetic
runs whose numbers are known."""

import pytest

from benchmark import devicetrace as trace
from benchmark.bounds import HBM_BYTES_PER_S, entry_seconds
from benchmark.harness import Run, Spans, load_cell, load_module

MS = 1_000_000  # ns


def metric(name, run):
    return load_module("metrics", name).read(run)


def synthetic_run():
    """A 10 ms window opening at t = 1000 ms: two ATen kernels of 2 ms
    (overlapping by 1 ms), one program kernel of 1 ms, a 1 ms copy, and
    a kernel past the window's end; 4 pages."""
    t = trace.Trace(open_ns=1000 * MS)
    t.device = [(1001 * MS, 1003 * MS, "aten_a", "kernel", False),
                (1002 * MS, 1004 * MS, "aten_b", "kernel", False),
                (1005 * MS, 1006 * MS, "flood_kernel", "kernel", True),
                (1007 * MS, 1008 * MS, "Memcpy HtoD", "memcpy", False),
                (1012 * MS, 1013 * MS, "late", "kernel", False)]
    t.host = [(1000 * MS, 1000 * MS, "bench.open", 7),
              (1000 * MS, 1010 * MS, "bench.pipeline", 7),
              (1004 * MS, 1005 * MS + MS // 2, "aten::cumsum", 7)]
    cell = load_cell("cleanup-a4-300-resident")
    run = Run(cell=cell, shape=(2, 64, 32),
              window_s=0.010, pages=4, trace=t, spans=Spans(False),
              counters={"flood_round": 2, "linecount": 0})
    return run


def test_busy_idle_and_kernels():
    run = synthetic_run()
    assert trace.busy_seconds(run.trace, run.window_s) == pytest.approx(0.005)
    assert metric("device.idle_share", run) == pytest.approx(50.0)
    # ATen kernels 2 + 2 ms (summed, not merged) over 4 pages
    assert metric("torch_ops.device_ms_per_page", run) == pytest.approx(1.0)


def test_roofline_share_counts_work_over_program_kernel_time():
    run = synthetic_run()
    least = 2 * entry_seconds("flood_round", 2, 64, 32)
    assert least == pytest.approx(2 * 3 * 2 * 2 * 32 * 4 / HBM_BYTES_PER_S)
    assert metric("hand_kernels_roofline", run) == pytest.approx(
        100 * least / 0.001)
    run.trace.device = [e for e in run.trace.device if not e[4]]
    assert metric("hand_kernels_roofline", run) is None  # nothing to read


def test_roofline_share_reads_nothing_for_a_kernel_it_cannot_count():
    run = synthetic_run()
    run.counters["a_new_kernel"] = 3
    assert metric("hand_kernels_roofline", run) is None
    run.counters["a_new_kernel"] = 0  # counted but not run: no matter
    assert metric("hand_kernels_roofline", run) is not None


def test_every_program_counter_has_a_work_model():
    from benchmark.harness import program_counters

    counters = program_counters()
    assert {"linecount", "pack_rows", "flood_round", "noise_cert"} <= set(
        counters)
    assert all(entry_seconds(e, 2, 64, 32) > 0 for e in counters)


def test_breakdown():
    run = synthetic_run()
    ops = dict(trace.device_ops(run.trace, run.window_s))
    assert ops == pytest.approx({"aten_a": 0.002, "aten_b": 0.002,
                                 "flood_kernel": 0.001, "Memcpy HtoD": 0.001})
    gaps = dict(trace.idle_gaps(run.trace, run.window_s))
    # gaps 0-1, 4-5, 6-7, 8-10 ms; 4-5 ms falls inside aten::cumsum
    assert gaps == pytest.approx({"bench.pipeline": 0.004,
                                  "aten::cumsum": 0.001})


def test_span_and_rate_metrics():
    run = synthetic_run()
    run.t_open = 100.0
    run.spans.by_name = {"pipeline": [(100.0, 100.002), (100.004, 100.005)],
                         "source": [(99.0, 100.001), (100.009, 100.02)]}
    assert metric("pipeline.host_ms_per_page", run) == pytest.approx(0.75)
    assert metric("runner.source_wait_share", run) == pytest.approx(20.0)
    assert metric("pages_per_s", run) == pytest.approx(400.0)
    run.batch_ms = [float(i) for i in range(1, 101)]
    assert metric("batch_ms_p95", run) == pytest.approx(95.95)
    run.setup_s = 12.5
    assert metric("setup_s", run) == 12.5


def test_untraced_run_reads_nothing_from_a_trace():
    run = synthetic_run()
    run.trace = None
    for name in ("device.idle_share", "torch_ops.device_ms_per_page",
                 "hand_kernels_roofline"):
        assert metric(name, run) is None
