"""Observability: timers, throughput meters, roofline accounting (port of
`libpillowfight_tpu/utils/metrics.py`).

* `timed_fetch`          — wall time per call of a chained fn, ended by a
  device synchronize.
* `device_time`          — CUDA-event seconds per call of fn(*args).
* `measure_peak_hbm_bw`  — the card's copy bandwidth, measured.
* `Meter`                — pages/sec, MP/s aggregation for batch runners.
* `roofline`             — achieved-vs-peak bandwidth for a kernel given
  its bytes-touched model.
* `trace`                — a torch.profiler context writing a Chrome trace.
* `span`, `count`        — the program's spans and counts, kept while a
  profiler runs (`tracing`) and read back with `recorded`.
* `card_name_and_power`  — the card's name and power limit (nvidia-smi).
* `HBM_BYTES_PER_S`, `F32_OPS_PER_S`, `SLOTS_PER_S`, `SFU_OPS_PER_S`,
  `ACE_SLOTS_PER_PIXEL_SAMPLE` — the card's published peaks and the ACE
  spray's work, from which bounds are reckoned.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass, field

import torch

# the card's published peaks (H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The ACE spray's work a pixel and sample, whatever implements it: the
# leanest form of the function known takes 10 issue slots of the f32 pipes
# (add for dy, FMA for d2, max, add for invd; a channel: one saturating
# add of pre-scaled values and one FMA) and one rsqrt of the
# special-function unit, which issues in a slot of its own: 11 slots. The
# card issues 128 f32 instructions a clock and SM (half its FMA rate in
# FLOP/s) and 16 special-function results.
ACE_SLOTS_PER_PIXEL_SAMPLE = 11
SLOTS_PER_S = F32_OPS_PER_S / 2
SFU_OPS_PER_S = SLOTS_PER_S / 8

# Peak device-memory bandwidth (bytes/s): unset until `set_peak_hbm_bw`
# or the first `roofline`, which measures it on the card.
_PEAK_HBM_BW: float | None = None


def set_peak_hbm_bw(bw_bytes_per_s: float) -> None:
    global _PEAK_HBM_BW
    _PEAK_HBM_BW = float(bw_bytes_per_s)


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def timed_fetch(fn, x, iters: int = 3):
    """Time fn by chaining iterations (out feeds in), synchronizing the
    device once after a warm call and once at the end. Returns
    (seconds_per_iter, last_output)."""
    out = fn(x)
    _sync(out)
    t0 = time.perf_counter()
    out = x
    for _ in range(iters):
        out = fn(out)
    _sync(out)
    return (time.perf_counter() - t0) / iters, out


def device_time(fn, *args, iters: int = 8) -> float:
    """Device seconds per call of `fn(*args)` on the current CUDA device:
    a warm call, then the CUDA-event time of `iters` back-to-back calls,
    the median of 3 such runs divided by `iters`."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(runs)


_COPY_BYTES, _COPY_ITERS = 1 << 30, 10


def measure_peak_hbm_bw(device=None) -> float:
    """Bytes/s of a 1 GiB device-to-device copy on a CUDA device (the
    current one by default), the mean of 10 copies after a warm one,
    timed with CUDA events: a copy reads and writes each byte once, so it
    moves 2 GiB."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_peak_hbm_bw needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"measure_peak_hbm_bw needs a CUDA device, got "
                           f"{dev}")
    src = torch.empty(_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    with torch.cuda.device(dev):
        dst.copy_(src)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(_COPY_ITERS):
            dst.copy_(src)
        end.record()
        end.synchronize()
    return 2 * _COPY_BYTES * _COPY_ITERS / (start.elapsed_time(end) / 1e3)


def card_name_and_power() -> tuple[str, str]:
    """(name, power limit) of the first card as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, for
    example ("NVIDIA H100 80GB HBM3", "700.00 W"); raises where
    nvidia-smi does not run."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    name, power = r.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()


@dataclass
class RooflineReport:
    seconds: float
    bytes_touched: int
    achieved_bw: float
    peak_bw: float

    @property
    def fraction_of_roofline(self) -> float:
        return self.achieved_bw / self.peak_bw

    def __str__(self) -> str:
        return (f"{self.achieved_bw/1e9:.1f} GB/s achieved of "
                f"{self.peak_bw/1e9:.0f} GB/s peak "
                f"({100*self.fraction_of_roofline:.1f}% of roofline)")


def roofline(seconds: float, bytes_touched: int) -> RooflineReport:
    """Achieved bandwidth vs peak for a memory-bound kernel. With no
    peak set, measures it once on the current CUDA device (and raises
    where there is none)."""
    if _PEAK_HBM_BW is None:
        set_peak_hbm_bw(measure_peak_hbm_bw())
    return RooflineReport(seconds, bytes_touched, bytes_touched / seconds,
                          _PEAK_HBM_BW)


@dataclass
class Meter:
    """Streaming throughput meter for the batch runners."""
    pages: int = 0
    megapixels: float = 0.0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def record(self, n_pages: int, h: int, w: int):
        self.pages += n_pages
        self.megapixels += n_pages * h * w / 1e6
        self.seconds = time.perf_counter() - self._t0

    @property
    def pages_per_sec(self) -> float:
        return self.pages / self.seconds if self.seconds else 0.0

    @property
    def mp_per_sec(self) -> float:
        return self.megapixels / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card); writes a Chrome trace, `trace.json`, into `logdir` (None: the
    reference's default, `pf_trace` in the temporary directory, which is
    `/tmp/pf_trace` unless TMPDIR names another; open it in Perfetto or
    chrome://tracing), where the program's spans are the `pft.*`
    ranges. Clears the span store first, so `recorded()` after the block
    holds the block's spans and counts. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "pf_trace")
    os.makedirs(logdir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ------------------------------------------------------------------ spans
#
# The program opens a span at each layer boundary and around the work the
# measurements point at, and counts what a ratio needs where the work
# happens. Both record only while a torch.profiler session runs
# (`tracing`): with none, a span is a shared no-op context and a count
# returns at once, so the untraced paths read and allocate nothing more.

MAX_RECORDS = 200_000  # spans, and counts, kept until `clear`


def tracing() -> bool:
    """True while a torch.profiler session runs: the one switch of the
    program's spans and counts."""
    return torch.autograd._profiler_enabled()


@dataclass
class SpanRecord:
    """One span: host `time.perf_counter()` seconds at its enter (t0)
    and exit (t1); its id, its parent's (the innermost span open on the
    same thread when it opened) and its request (the id the spans of one
    runner chunk or one pipeline call share). device_s: the seconds its
    CUDA stream took from the span's enter to its exit (its device work,
    and any idle the host left inside it), where the span was given a
    CUDA tensor; None otherwise."""
    name: str
    id: int
    parent: int | None
    request: int | None
    thread: int
    t0: float
    t1: float = 0.0
    device_s: float | None = None
    events: tuple | None = field(default=None, repr=False)


@dataclass
class CountRecord:
    """One count: its value (an int; a one-element device tensor until
    `recorded` sums it), the host time it was made at, and the span it
    was made in."""
    name: str
    value: object
    t: float
    parent: int | None
    request: int | None


@dataclass
class Records:
    """What `recorded` returns."""
    spans: list        # SpanRecord, by host start
    counts: list       # CountRecord, in the order made
    dropped: int       # spans and counts past MAX_RECORDS, not kept


class _Store:
    """The spans and counts kept since the last `clear`, and each
    thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.requests = itertools.count()
        self.spans: list = []
        self.counts: list = []
        self.dropped = 0

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, kept: list, record) -> None:
        with self.lock:
            if len(kept) < MAX_RECORDS:
                kept.append(record)
            else:
                self.dropped += 1


_STORE = _Store()
_OFF = contextlib.nullcontext()


class _Span:
    def __init__(self, name: str, request, device):
        self.name, self.request, self.device = name, request, device

    def __enter__(self):
        stack = _STORE.stack()
        parent = stack[-1] if stack else None
        request = self.request
        if request is None and parent is not None:
            request = parent.request
        self.rf = torch.profiler.record_function(f"pft.{self.name}")
        self.rf.__enter__()
        self.rec = SpanRecord(self.name, next(_STORE.ids),
                              None if parent is None else parent.id, request,
                              threading.get_ident(), 0.0)
        self.stream = None
        d = self.device
        if d is not None and d.is_cuda:
            self.stream = torch.cuda.current_stream(d.device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        stack.append(self.rec)
        self.rec.t0 = time.perf_counter()
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter()
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            rec.events = (self.start, end)
        _STORE.stack().pop()
        self.rf.__exit__(*exc)
        _STORE.keep(_STORE.spans, rec)
        return False


def span(name: str, request: int | None = None, device=None):
    """A context that, while a profiler runs, opens the profiler range
    `pft.<name>` and keeps a `SpanRecord` of the block. request: the
    span's request id (None: its parent's). device: a tensor whose
    current CUDA stream is timed across the block by a pair of CUDA
    events, read back only by `recorded`. With no profiler, a no-op."""
    if not tracing():
        return _OFF
    return _Span(name, request, device)


def count(name: str, value) -> None:
    """Keep a count (an int, or a one-element tensor that `recorded`
    sums: nothing is read back here) with the host time and the span it
    is made in, while a profiler runs."""
    if not tracing():
        return
    stack = _STORE.stack()
    parent = stack[-1] if stack else None
    _STORE.keep(_STORE.counts, CountRecord(
        name, value, time.perf_counter(),
        None if parent is None else parent.id,
        None if parent is None else parent.request))


def new_request() -> int | None:
    """A fresh request id for a call made outside any span, while a
    profiler runs; None inside a span (its spans take the enclosing
    request) or with no profiler."""
    if not tracing() or _STORE.stack():
        return None
    return next(_STORE.requests)


def recorded() -> Records:
    """The spans and counts kept since the last `clear`. Resolves what
    was left on the card: each device span's stream time (waiting for
    its end event) and each tensor count's sum."""
    with _STORE.lock:
        spans, counts = list(_STORE.spans), list(_STORE.counts)
        dropped = _STORE.dropped
    for s in spans:
        if s.events is not None:
            start, end = s.events
            end.synchronize()
            s.device_s = start.elapsed_time(end) / 1e3
            s.events = None
    for c in counts:
        if isinstance(c.value, torch.Tensor):
            c.value = int(c.value.sum())
    return Records(sorted(spans, key=lambda s: (s.t0, s.id)), counts,
                   dropped)


def clear() -> None:
    """Empty the span and count store."""
    with _STORE.lock:
        _STORE.spans, _STORE.counts, _STORE.dropped = [], [], 0
