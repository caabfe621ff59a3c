"""The device trace of a `--trace 1` run, read from torch.profiler's
Kineto events in memory (nothing is written to disk).

Device time is the union of the kernel, copy and set intervals, so
overlapping streams count once and copies are not missed. A kernel is
the program's own (a launch from its CUDA library through ctypes) when
no ATen operator launched it: PyTorch links every kernel it launches to
the operator that launched it, so the origin, and not a list of names,
tells the two apart.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    """Events in nanoseconds of the profiler's clock. device: (start,
    end, name, kind, from_program); host: (start, end, name, thread) of
    the operators and annotations; open_ns: the profiler's time of the
    window's opening mark."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    open_ns: int = 0


@contextlib.contextmanager
def capture(box: dict):
    """Profile the block; box["trace"] holds the Trace afterwards."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    box["trace"] = from_kineto(prof.profiler.kineto_results.events())


def mark_open():
    """A zero-length annotation that ties the host clock to the trace's."""
    with torch.profiler.record_function("bench.open"):
        pass


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def from_kineto(events) -> Trace:
    t = Trace()
    aten = set()
    dev = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if name == "bench.open":
                t.open_ns = e.start_ns()
            if e.is_user_annotation() or name.startswith("aten::"):
                t.host.append((e.start_ns(), e.end_ns(), name,
                               e.start_thread_id()))
                if not e.is_user_annotation():
                    aten.add(e.correlation_id())
        elif not e.is_user_annotation():  # not an annotation's device span
            dev.append(e)
    for e in dev:
        name = e.name()
        kind = _kind(name)
        t.device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                         kind, kind == "kernel"
                         and e.linked_correlation_id() not in aten))
    return t


def window_ns(t: Trace, window_s: float) -> tuple:
    return t.open_ns, t.open_ns + int(window_s * 1e9)


def _clip(events, lo, hi):
    for e in events:
        a, b = max(e[0], lo), min(e[1], hi)
        if b > a:
            yield a, b, e


def union(intervals) -> list:
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(t: Trace, window_s: float) -> float:
    """Seconds of the window in which any device operation ran."""
    lo, hi = window_ns(t, window_s)
    return sum(b - a for a, b in union(
        (a, b) for a, b, _ in _clip(t.device, lo, hi))) / 1e9


def kernel_seconds(t: Trace, window_s: float, from_program: bool) -> float:
    """Summed device time of the window's kernels of one origin."""
    lo, hi = window_ns(t, window_s)
    return sum(b - a for a, b, e in _clip(t.device, lo, hi)
               if e[3] == "kernel" and e[4] == from_program) / 1e9


def device_ops(t: Trace, window_s: float, top: int = 10) -> list:
    """[[name, seconds], ...]: the device operations that took most time."""
    lo, hi = window_ns(t, window_s)
    by = {}
    for a, b, e in _clip(t.device, lo, hi):
        by[e[2]] = by.get(e[2], 0) + (b - a)
    return [[k, v / 1e9] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(t: Trace, window_s: float, top: int = 10) -> list:
    """[[host activity, seconds], ...]: the window's idle device time,
    each gap named by the innermost operator or annotation the host's
    main thread was in at the gap's middle, summed by name."""
    lo, hi = window_ns(t, window_s)
    busy = union((a, b) for a, b, _ in _clip(t.device, lo, hi))
    gaps, last = [], lo
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if hi > last:
        gaps.append((last, hi))
    main = [e for e in t.host if e[3] == _main_thread(t)]
    main.sort(key=lambda e: (e[0], -e[1]))
    by, stack, i = {}, [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(main) and main[i][0] <= mid:
            while stack and stack[-1][1] <= main[i][0]:
                stack.pop()
            stack.append(main[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host outside any traced op"
        by[name] = by.get(name, 0) + (b - a)
    return [[k, v / 1e9] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _main_thread(t: Trace):
    for e in t.host:
        if e[2] == "bench.open":
            return e[3]
    return None
