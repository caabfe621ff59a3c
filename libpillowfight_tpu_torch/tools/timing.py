"""Timing shared by the port's measurement tools.

* `device`          — cuda:0 by default; raises without a card unless
  given "cpu" (the tests run the tools on the CPU).
* `timed_calls`     — seconds of each call of fn on batches taken in turns:
  CUDA events around each call on the card, the host clock on the CPU.
* `device_seconds`  — `utils.metrics.device_time` on the card, None on
  the CPU.
* `time_chain`      — the headline measurement: DOCUMENT_CLEANUP on int32
  words, timed call by call after the chain has warmed the card
  (`bench_torch.py` and `bench_suite` config 3 both take it).
* `page_batches`, `word_batches` — distinct dirty batches of
  `utils.pages.synthetic_pages`, one seed a batch.
* `Profile`         — a profile tool's record: stage -> device ms and MP/s,
  "not measured" for every time on the CPU.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from ..core.bitmap import pages_to_words
from ..parallel.pipeline import DOCUMENT_CLEANUP, compile_pipeline
from ..utils import metrics
from ..utils.pages import synthetic_pages

A4 = (3508, 2480)       # 300 dpi A4, ~8.7 MP
A4_600 = (7016, 4960)   # 600 dpi A4, ~34.8 MP
NOT_MEASURED = "not measured"
# Seconds of chain calls before the headline's timed calls: right after
# long work on the CPU the card's clocks are down, and the chain reads
# slow until seconds of device work have brought them up.
WARM_S = 2.0

_REPO = Path(__file__).resolve().parents[2]


def device(device=None) -> torch.device:
    """cuda:0 for None; raises RuntimeError where there is no card
    unless the device asked for is the CPU."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain versions on the CPU")
        torch.cuda.init()  # the allocator's statistics exist from here on
    return dev


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return ", ".join(metrics.card_name_and_power())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_calls(fn, batches, iters: int, dev: torch.device,
                warm_s: float = 0.0):
    """(seconds of each of `iters` calls, output of the last call): the
    calls take the batches in turns, after warm-up calls on the first
    batch, one at least and more until `warm_s` seconds have passed. On
    the card each call is timed by CUDA events read after a synchronize,
    on the CPU by the host clock."""
    t0 = time.perf_counter()
    fn(batches[0])
    sync(dev)
    while time.perf_counter() - t0 < warm_s:
        fn(batches[0])
        sync(dev)
    times, out = [], None
    for i in range(iters):
        x = batches[i % len(batches)]
        del out
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t1 = time.perf_counter()
            out = fn(x)
            times.append(time.perf_counter() - t1)
    return times, out


def device_seconds(fn, x, dev: torch.device, iters: int = 3):
    """`metrics.device_time` on the card; None on the CPU."""
    if dev.type != "cuda":
        return None
    return metrics.device_time(fn, x, iters=iters)


def time_chain(batches, iters: int, dev: torch.device):
    """The headline measurement: DOCUMENT_CLEANUP through the port's
    `compile_pipeline` on resident int32 word batches taken in turns,
    `iters` calls timed one by one after `WARM_S` seconds of chain calls
    on the card (one call on the CPU). Returns (seconds of each call,
    output of the last)."""
    return timed_calls(compile_pipeline(DOCUMENT_CLEANUP), batches, iters,
                       dev, WARM_S if dev.type == "cuda" else 0.0)


def page_batches(b: int, h: int, w: int, dev: torch.device, n: int = 2):
    """n distinct dirty batches of uint8 RGBA pages on dev, seeds 0..n-1
    (`utils.pages.synthetic_pages`, the page of the reference's bench)."""
    return [torch.from_numpy(synthetic_pages(b, h, w, seed=s)).to(dev)
            for s in range(n)]


def word_batches(b: int, h: int, w: int, dev: torch.device, n: int = 2):
    """The same pages as int32 words [b, h, w]."""
    return [pages_to_words(p) for p in page_batches(b, h, w, dev, n)]


def _line(label: str, ms, mps) -> str:
    if ms == NOT_MEASURED:
        return f"{label:46s} {NOT_MEASURED}"
    return f"{label:46s} {ms:9.3f} ms  {mps:9.0f} MP/s"


class Profile:
    """A profile tool's record. Each `stage` computes its output once and,
    on the card, takes its device time by `metrics.device_time` (`iters`
    calls back to back, the median of 3 runs); on the CPU every time is
    NOT_MEASURED. Each stage is printed as it is taken."""

    def __init__(self, tool: str, dev: torch.device, shape, iters: int):
        self.dev, self.iters = dev, iters
        b, h, w = shape
        self.mp = b * h * w / 1e6
        self.rec = {"tool": tool, "device": card_label(dev),
                    "shape": [b, h, w], "iters": iters, "ms": {},
                    "mp_per_s": {}}

    def put(self, label: str, seconds) -> None:
        """Record a time taken elsewhere (None: not measured)."""
        ms = NOT_MEASURED if seconds is None else seconds * 1e3
        mps = NOT_MEASURED if seconds is None else self.mp / seconds
        self.rec["ms"][label] = ms
        self.rec["mp_per_s"][label] = mps
        print(_line(label, ms, mps), flush=True)

    def stage(self, label: str, fn, *args):
        """fn(*args), its output returned; its device time recorded."""
        out = fn(*args)
        self.put(label, metrics.device_time(fn, *args, iters=self.iters)
                 if self.dev.type == "cuda" else None)
        return out

    def total(self, label: str, labels) -> None:
        """The sum of stages already taken."""
        ms = [self.rec["ms"][k] for k in labels]
        self.put(label, None if NOT_MEASURED in ms else sum(ms) / 1e3)


def write(tool: str, rec) -> Path:
    """Write a tool's record (or list of records) to
    chiprun_out/<tool>_torch.json under the repository."""
    path = _REPO / "chiprun_out" / f"{tool}_torch.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    return path
