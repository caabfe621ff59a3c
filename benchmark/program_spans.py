"""The program's own spans and counts, as the per-layer metrics that read
them see them: what `libpillowfight_tpu_torch.utils.metrics.recorded()`
holds after a `--trace 1` run (the program keeps them only while a
profiler runs), clipped to the window on the host clock.

A version of the program that keeps no spans (no `recorded`), or a run
that recorded none of a metric's spans in the window, reads nothing: the
metric is left out of the line.
"""

from __future__ import annotations


def records():
    """The program's records (spans, counts), or None where it keeps
    none."""
    try:
        from libpillowfight_tpu_torch.utils import metrics
    except ImportError:
        return None
    recorded = getattr(metrics, "recorded", None)
    return None if recorded is None else recorded()


def _window(run) -> tuple:
    return run.t_open, run.t_open + run.window_s


def _matches(name: str, names) -> bool:
    return any(name == n or (n.endswith(".") and name.startswith(n))
               for n in names)


def spans(run, names, outermost: bool = True) -> list | None:
    """The spans named by `names` (a name, or a prefix ending in ".")
    that overlap the window; with `outermost`, only those no ancestor of
    which is also named. None where the program keeps no records."""
    rec = records()
    if rec is None:
        return None
    lo, hi = _window(run)
    by_id = {s.id: s for s in rec.spans}

    def named_ancestor(s) -> bool:
        p = by_id.get(s.parent)
        while p is not None:
            if _matches(p.name, names):
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in rec.spans if _matches(s.name, names)
            and s.t1 > lo and s.t0 < hi
            and not (outermost and named_ancestor(s))]


def host_seconds(run, names) -> float | None:
    """Host seconds of the outermost `names` spans inside the window (as
    `Spans.seconds` clips); None where the window holds none."""
    found = spans(run, names)
    if not found:
        return None
    lo, hi = _window(run)
    return sum(max(0.0, min(s.t1, hi) - max(s.t0, lo)) for s in found)


def stream_seconds(run, names) -> float | None:
    """Stream seconds (CUDA events) of the outermost `names` spans that
    start in the window; None where the window holds none, or where a
    span has no stream time (it ran on no card)."""
    lo, hi = _window(run)
    found = [s for s in spans(run, names) or () if lo <= s.t0 <= hi]
    if not found or any(s.device_s is None for s in found):
        return None
    return sum(s.device_s for s in found)


def counts_in(run, name: str, parents: list) -> int:
    """The sum of the `name` counts made inside the spans `parents`."""
    rec = records()
    ids = {s.id for s in parents}
    return sum(c.value for c in rec.counts
               if c.name == name and c.parent in ids)


def per_page(run, seconds) -> float | None:
    """ms a page completed in the window."""
    if seconds is None or not run.pages:
        return None
    return 1e3 * seconds / run.pages
