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
* `card_name_and_power`  — the card's name and power limit (nvidia-smi).
* `HBM_BYTES_PER_S`, `F32_OPS_PER_S`, `SLOTS_PER_S`, `SFU_OPS_PER_S`,
  `ACE_SLOTS_PER_PIXEL_SAMPLE` — the card's published peaks and the ACE
  spray's work, from which bounds are reckoned.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
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
def trace(logdir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a
    card); writes a Chrome trace, `trace.json`, into `logdir` (open it in
    Perfetto or chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
