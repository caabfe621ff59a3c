"""What every cell shares: its files found by name, the run's record,
the benchmark's own spans, the program's counters, the window's clock,
the comparison with the plain reference, and the result's line.

A cell is `workloads/<name>.json`; it names its configuration
(`configs/<config>.json`) and its driver (`drivers/<driver>.py`). The
metrics a cell reports are the entries of BENCHMARK.json whose
`workloads` list it (every per-layer entry lists its cells); each is
read by `metrics/<metric>.py`. Adding any of these is adding files and
entries.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "libpillowfight_tpu", "pillowfight")
# the package whose modules keep the program's launch counters
COUNTER_PACKAGE = "libpillowfight_tpu_torch.ops.cuda"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, by file (a metric's name has dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    e2e: list            # BENCHMARK.json end_to_end entries it reports
    per_layer: list      # BENCHMARK.json per_layer entries it reports

    @property
    def params(self) -> dict:
        return self.workload["params"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT, "BENCHMARK.json")
    workload = load_json(HERE, "workloads", f"{name}.json")
    config = load_json(HERE, "configs", f"{workload['config']}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, workload, config, e2e, per_layer)


class Spans:
    """The benchmark's own spans around its calls into the program: host
    clock intervals by name, and in a traced run also a profiler
    annotation `bench.<name>` each."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.by_name: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(f"bench.{name}")
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.by_name.setdefault(name, []).append(
                    (t0, time.perf_counter()))

    def seconds(self, name: str, lo: float, hi: float) -> float:
        """Seconds of the `name` spans that lie in [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for a, b in self.by_name.get(name, ()))


def program_counters() -> dict:
    """The program's launch counters, entry -> calls so far: every module
    of its CUDA package that keeps `launches`, a count (the entry is the
    module's name) or a dict of counts by entry. A counter a later
    change adds is read as it is; none is named here."""
    import pkgutil

    out = {}
    package = importlib.import_module(COUNTER_PACKAGE)
    for info in pkgutil.iter_modules(package.__path__):
        n = getattr(importlib.import_module(
            f"{COUNTER_PACKAGE}.{info.name}"), "launches", None)
        if isinstance(n, dict):
            out.update(n)
        elif isinstance(n, int):
            out[info.name] = n
    return out


@dataclass
class Run:
    """What one run measured; the metrics read it."""
    cell: Cell
    shape: tuple = ()          # (pages a call, H, W)
    setup_s: float = 0.0
    t_open: float = 0.0        # host clock of the window's opening
    window_s: float = 0.0
    pages: int = 0             # pages completed in the window
    calls: int = 0
    batch_ms: list = field(default_factory=list)
    spans: Spans | None = None
    counters: dict = field(default_factory=dict)
    trace: object = None
    compared: list = field(default_factory=list)  # (name, value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    def span_seconds(self, name: str) -> float:
        return self.spans.seconds(name, self.t_open,
                                  self.t_open + self.window_s)


def counters_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (whole names: libpillowfight_tpu_torch is not one)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def mismatched_words(got, want) -> int:
    """Words (pixels) that differ between two int32 word batches."""
    if got.shape != want.shape:
        return int(want.numel())
    return int((got != want).sum())


def result_line(run: Run, device: dict, metrics: dict, breakdown=None) -> str:
    ok = all(v <= lim for _, v, lim in run.compared)
    out = {"correct": ok and run.failed == 0, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in run.compared}
    return json.dumps(out)
