"""Per-filter throughput of the port on the card (the counterpart of the
reference's `tools/profile_filters.py`).

    python -m libpillowfight_tpu_torch.tools.profile_filters [--b 2]
        [--h 3508] [--w 2480] [--iters 3] [--filters a,b]

Every filter name of `parallel.pipeline` runs alone on uint8 RGBA pages
of `utils.pages.synthetic_pages`. Two distinct dirty batches are taken in
turns: an output never feeds the next input. The reference's tool chained
its calls, and after the first call its unpaper filters were handed a
page they had already cleaned. Each filter gets the median CUDA-event
time of one call (`ms`, and MP/s from it) and `metrics.device_time` of
calls back to back (`device_ms`). `bench_suite` config 6 takes the same
`filter_times`. The record goes to
`chiprun_out/profile_filters_torch.json`. Raises without a card;
`measure(device="cpu")` computes every output on the CPU and writes "not
measured" for every time.
"""

from __future__ import annotations

import argparse
import statistics

from ..ops import unpaper
from ..parallel.pipeline import _FILTERS, _PAGE_FILTERS
from . import timing

# name -> the filter a user calls on uint8 RGBA pages
FILTERS = {name: getattr(unpaper, name) if name.startswith("unpaper_")
           else _PAGE_FILTERS[name] for name in _FILTERS}


def filter_times(fn, batches, iters: int, dev):
    """(median seconds of one call over `iters` calls on the batches in
    turns after a warm call, `metrics.device_time` seconds of `iters` calls
    back to back on the first batch, or None on the CPU)."""
    times, _ = timing.timed_calls(fn, batches, iters, dev)
    return (statistics.median(times),
            timing.device_seconds(fn, batches[0], dev, iters=iters))


def measure(b: int = 2, h: int = timing.A4[0], w: int = timing.A4[1],
            iters: int = 3, filters=None, device=None) -> dict:
    """{filter: ms, MP/s, device ms} for the filters named (all of
    `FILTERS` by default) on b pages of h x w."""
    dev = timing.device(device)
    xs = timing.page_batches(b, h, w, dev)
    mp = b * h * w / 1e6
    na = timing.NOT_MEASURED
    rec = {"tool": "profile_filters", "device": timing.card_label(dev),
           "shape": [b, h, w], "iters": iters, "ms": {}, "mp_per_s": {},
           "device_ms": {}}
    for name in filters or FILTERS:
        dt, dtd = filter_times(FILTERS[name], xs, iters, dev)
        if dtd is None:  # the CPU: its clock is no device's
            ms = mps = dms = na
            print(f"{name:24s} {na}", flush=True)
        else:
            ms, mps, dms = dt * 1e3, mp / dt, dtd * 1e3
            print(f"{name:24s} {mps:10.1f} MP/s   {ms:9.3f} ms/iter   "
                  f"{dms:9.3f} ms device", flush=True)
        rec["ms"][name] = ms
        rec["mp_per_s"][name] = mps
        rec["device_ms"][name] = dms
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--h", type=int, default=timing.A4[0])
    ap.add_argument("--w", type=int, default=timing.A4[1])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--filters", type=str, default="")
    args = ap.parse_args(argv)
    rec = measure(args.b, args.h, args.w, args.iters,
                  args.filters.split(",") if args.filters else None)
    print(f"wrote {timing.write('profile_filters', rec)}")


if __name__ == "__main__":
    main()
