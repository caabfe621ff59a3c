"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (loading, the first build of the program's kernels, the inputs
made from the seed, warm calls of every shape) is timed as `setup_s`;
then the window runs for `--seconds` (with `--trace 1`, under the
profiler, for the cell's `trace_seconds` at most). After the window the
outputs the timed path kept are compared with the plain reference, and
the last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` with
`--trace 1`), and last `compared`, each compared number beside its
limit. Exits 2 without enough CUDA cards, 3 if the JAX stack was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the benchmark's modules import as `benchmark.*`, never by their bare
# names (its `devicetrace`, `pages`, ... would shadow nothing then)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

from benchmark import devicetrace as trace  # noqa: E402
from benchmark.harness import (Run, Spans, counters_delta,  # noqa: E402
                               forbidden_modules, load_cell, load_module, log,
                               program_counters, result_line)

REFERENCE_PIXELS = 36_000_000  # pages of a reference block: ~4 A4 at 300 dpi


class Context:
    """What a driver gets: the cell, the seed, the window's length, the
    device, the run's record, and the reference."""

    def __init__(self, cell, seed: int, seconds: float, device, run: Run,
                 ref_dtype=None):
        import torch

        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.run = device, run
        self.ref_dtype = ref_dtype or torch.float32
        self._exits: list = []

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def on_exit(self, fn) -> None:
        self._exits.append(fn)

    def close(self) -> None:
        while self._exits:
            self._exits.pop()()

    def reference(self, pages, spec):
        """The plain reference of `spec` over host uint8 RGBA pages [n,
        H, W, 4], on the device in blocks: int32 words [n, H, W]."""
        import torch

        from benchmark import reference

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        n, h, w = pages.shape[:3]
        block = max(1, REFERENCE_PIXELS // (h * w))
        out = []
        for i in range(0, n, block):
            words = torch.from_numpy(pages[i:i + block]).view(
                torch.int32).squeeze(-1).to(self.device)
            out.append(reference.run(words, spec, self.ref_dtype))
        return torch.cat(out)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> str | None:
    """One run of the cell; the result line, or None where the JAX stack
    was loaded."""
    import torch

    run = Run(cell=cell, spans=Spans(traced))
    if traced:
        seconds = min(seconds, cell.params.get("trace_seconds", seconds))
    ctx = Context(cell, seed, seconds, device, run)
    driver = load_module("drivers", cell.workload["driver"])
    cuda = device.type == "cuda"
    try:
        state = driver.setup(ctx)
        p = cell.params
        run.shape = (p.get("batch", p.get("chunk")), p["height"], p["width"])
        before = program_counters()
        box: dict = {}
        with trace.capture(box) if traced else contextlib.nullcontext():
            run.t_open = time.perf_counter()
            if traced:
                trace.mark_open()
            run.setup_s = run.t_open - t_start
            driver.window(ctx, state)
            ctx.sync()
        run.counters = counters_delta(before, program_counters())
        run.trace = box.get("trace")
        if cuda:
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        log(f"window: {run.window_s:.3f} s, {run.pages} pages, {run.calls} "
            f"calls; set-up {run.setup_s:.3f} s; launches {run.counters}")
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
        if cuda:
            dev["power"] = power_limit()
        t0 = time.perf_counter()
        driver.check(ctx, state)
        log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")
    finally:
        ctx.close()
    metrics = {}
    for m in cell.per_layer if traced else cell.e2e:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if run.trace is not None:
        dev["busy_s"] = trace.busy_seconds(run.trace, run.window_s)
        dev["window_s"] = run.window_s
        breakdown = {"device_ops": trace.device_ops(run.trace, run.window_s),
                     "idle_gaps": trace.idle_gaps(run.trace, run.window_s)}
    found = forbidden_modules()
    if found:
        log(f"the JAX stack or the JAX package was loaded: {found}")
        return None
    for name, value, limit in run.compared:
        log(f"compared {name}: {value} (limit {limit})")
    return result_line(run, dev, metrics, breakdown)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START)
    if line is None:
        return 3
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
