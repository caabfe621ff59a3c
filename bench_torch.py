"""Headline benchmark of the PyTorch port: the unpaper cleanup chain on
one CUDA card, in MP/s (the port's counterpart of `bench.py`).

    python bench_torch.py [--quick]

DOCUMENT_CLEANUP through the port's `compile_pipeline` on A4 300 dpi
pages (3508 x 2480), 16 a batch, as int32 words resident on cuda:0: two
distinct dirty batches of `utils.pages.synthetic_pages` (seeds 0 and 1,
the page of `bench.py`) in turns, timed by
`tools.timing.time_chain` (seconds of chain calls to warm the card, then
7 calls each timed by CUDA events; the median counts). `--quick` takes
512 x 512 x 2. `vs_baseline` divides by the single-core C oracle's rate
for the same six filters at the same page size (`pf_oracle
bench-unpaper-chain H W`, built from `oracle/`); it is null only where
the oracle cannot be built. Page 0 of the last timed output must be
bit-identical to the plain chain on the CPU for the same page, or the
script fails. It needs a card: without one it exits non-zero. It writes
no file.

Prints ONE JSON line last: {"metric", "value", "unit", "vs_baseline",
"device", "calls", "ms_min", "ms_max"}; the rest goes on earlier lines.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from libpillowfight_tpu_torch.core.bitmap import pages_to_words
from libpillowfight_tpu_torch.parallel.pipeline import (DOCUMENT_CLEANUP,
                                                         compile_pipeline)
from libpillowfight_tpu_torch.tools import timing
from libpillowfight_tpu_torch.utils import oracle
from libpillowfight_tpu_torch.utils.pages import synthetic_pages

BATCH = 16
QUICK = (2, 512, 512)
CALLS = 7  # odd: the last timed call takes the first (seed-0) batch


def plain_page(h: int, w: int) -> torch.Tensor:
    """The plain chain on the CPU on page 0 of the seed-0 batch: int32
    words [1, h, w] (every page of a batch is the same)."""
    page = torch.from_numpy(synthetic_pages(1, h, w, seed=0))
    return compile_pipeline(DOCUMENT_CLEANUP)(pages_to_words(page))


def run(quick: bool = False, device=None, plain=None) -> dict:
    """The record. device: cuda:0 by default (raises without a card),
    "cpu" for the tests (the chain's plain version; no time is measured
    there, and the oracle does not run). plain: `plain_page(h, w)` where
    the caller has it already. Raises AssertionError where page 0 of the
    last timed output differs from it."""
    dev = timing.device(device)
    b, h, w = QUICK if quick else (BATCH, *timing.A4)
    batches = timing.word_batches(b, h, w, dev)
    seconds, out = timing.time_chain(batches, CALLS, dev)
    want = plain_page(h, w) if plain is None else plain
    got = out[:1].cpu()
    if not torch.equal(got, want):
        raise AssertionError(
            f"page 0 of the last timed call differs from the plain chain on "
            f"the CPU on {int((got != want).sum())} of {h * w} pixels")
    print("check: page 0 of the last timed call bit-identical to the plain "
          "chain on the CPU", flush=True)
    rec = {"metric": "unpaper_cleanup_pipeline_throughput",
           "value": timing.NOT_MEASURED, "unit": "MP/s/chip",
           "vs_baseline": None, "device": timing.card_label(dev),
           "calls": CALLS, "ms_min": timing.NOT_MEASURED,
           "ms_max": timing.NOT_MEASURED}
    if dev.type != "cuda":
        return rec
    mps = b * h * w / 1e6 / statistics.median(seconds)
    print(f"chain {b} x {h} x {w}: ms a call "
          f"{[round(s * 1e3, 4) for s in seconds]}", flush=True)
    rec.update(value=mps, ms_min=min(seconds) * 1e3,
               ms_max=max(seconds) * 1e3)
    try:
        base = oracle.bench_unpaper_chain(h, w)["mp_per_sec"]
    except RuntimeError as e:  # the oracle cannot be built or run here
        print(f"vs_baseline: null ({e})", file=sys.stderr, flush=True)
    else:
        print(f"oracle (pf_oracle bench-unpaper-chain {h} {w}): {base} MP/s",
              flush=True)
        rec["vs_baseline"] = mps / base
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--quick"]):
        print("usage: bench_torch.py [--quick]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 1
    print(json.dumps(run(quick=argv == ["--quick"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
