"""Large-batch runner: resumable, metered page processing over the cards
(port of `libpillowfight_tpu/parallel/batch.py`).

  * page-index manifest for resume (crash -> rerun skips finished
    chunks); a manifest written by either package resumes under the
    other: same lines, claim files and chunk ownership,
  * chunks round-robin over the devices (data parallelism over pages: a
    page fits one card),
  * structured throughput metrics (pages/sec, MP/s, per-chunk timings),
  * per-chunk retry (transient failure -> bounded re-execution),
  * work stealing from hosts whose heartbeat went stale.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .pipeline import compile_pipeline, normalize_spec

# retry only device/runtime failures (CUDA errors, torch.cuda.
# OutOfMemoryError, both RuntimeErrors; I/O errors). Programming errors —
# TypeError, ValueError, a broken source callback — re-raise immediately:
# retrying them wastes max_retries re-executions and then masks the real
# traceback depth.
_RETRYABLE = (RuntimeError, OSError)


def map_chunked(fn, pages: torch.Tensor, chunk: int) -> torch.Tensor:
    """Apply fn over the batch axis in chunks of `chunk` pages and
    concatenate the results.

    Bounds peak device memory by the per-chunk live set instead of the
    whole batch's: a 64-page A4 canny holds ~6 full-res f32 planes. The
    batch must divide evenly into chunks (pad the tail upstream —
    BatchRunner already chunks its manifest this way)."""
    b = pages.shape[0]
    if b <= chunk:
        return fn(pages)
    if b % chunk:
        raise ValueError(f"batch {b} not divisible by chunk {chunk}")
    return torch.cat([fn(pages[i:i + chunk]) for i in range(0, b, chunk)])


@dataclass
class BatchMetrics:
    pages: int = 0
    megapixels: float = 0.0
    seconds: float = 0.0
    chunks: int = 0
    retries: int = 0
    stolen: int = 0
    chunk_seconds: list = field(default_factory=list)

    @property
    def pages_per_sec(self) -> float:
        return self.pages / self.seconds if self.seconds else 0.0

    @property
    def mp_per_sec(self) -> float:
        return self.megapixels / self.seconds if self.seconds else 0.0

    def to_dict(self) -> dict:
        return {
            "pages": self.pages,
            "megapixels": round(self.megapixels, 3),
            "seconds": round(self.seconds, 4),
            "pages_per_sec": round(self.pages_per_sec, 2),
            "mp_per_sec": round(self.mp_per_sec, 2),
            "chunks": self.chunks,
            "retries": self.retries,
            "stolen": self.stolen,
        }


def _devices(devices) -> list[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run "
                               "the plain versions on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices is empty")
    return out


class BatchRunner:
    """Process a large page set through a pipeline in chunks.

    `source(indices) -> uint8 [n, H, W, 4]` supplies pages on demand;
    `sink(indices, pages)` consumes results (host numpy, uint8). The
    manifest file records finished chunk start-indices, making reruns
    resumable.
    """

    def __init__(self, spec, chunk_size: int = 64, devices=None,
                 manifest_path: str | None = None, max_retries: int = 2,
                 host_id: int = 0, n_hosts: int = 1, heartbeat=None,
                 steal_poll: float = 1.0):
        """devices: where chunks run, round-robin (None: every CUDA
        device; raises where there is none). host_id/n_hosts partition
        chunks round-robin across hosts (a chunk's owner = chunk_index %
        n_hosts); `heartbeat` (a multihost.Heartbeat over a shared
        directory) enables the failure RESPONSE: after finishing its own
        chunks, a host steals and reprocesses the unfinished chunks of
        any host whose heartbeat has gone stale, and waits on live peers
        until the whole batch is done. Steals are de-duplicated via
        O_EXCL claim files next to the manifest (a claim older than the
        heartbeat timeout is treated as abandoned and re-claimable), so
        completion is at-least-once."""
        self.spec = normalize_spec(spec)
        self.fn = compile_pipeline(self.spec)
        self.chunk_size = chunk_size
        self.devices = _devices(devices)
        self.manifest_path = manifest_path
        self.max_retries = max_retries
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.heartbeat = heartbeat
        self.steal_poll = steal_poll
        if heartbeat is not None and manifest_path is None:
            raise ValueError("work stealing needs a shared manifest_path")
        self._done: set[int] = set()
        self._streams: dict = {}   # cuda device -> (h2d, d2h) side streams
        self._dispatched = 0       # round-robin position over the devices
        self._reload_done()

    def _reload_done(self) -> None:
        """Sync finished-chunk set from the (shared) manifest file."""
        if self.manifest_path and os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._done.add(json.loads(line)["start"])

    def _mark_done(self, start: int, n: int, dt: float) -> None:
        self._done.add(start)
        if self.manifest_path:
            with open(self.manifest_path, "a") as f:
                f.write(json.dumps({"start": start, "n": n, "dt": round(dt, 4),
                                    "host": self.host_id}) + "\n")
            # drop any steal-claim marker: the manifest line above is the
            # durable completion record, the claim was only a dedup lock
            try:
                os.remove(f"{self.manifest_path}.claim.{start}")
            except OSError:
                pass

    def _owner(self, start: int) -> int:
        return (start // self.chunk_size) % self.n_hosts

    def _claim(self, start: int) -> bool:
        """Try to claim a steal target (O_EXCL file). Stale claims (older
        than the heartbeat timeout — the claimer died too) are overridden."""
        path = f"{self.manifest_path}.claim.{start}"
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                return False
            if age <= self.heartbeat.timeout:
                return False
            os.utime(path)  # adopt the abandoned claim
            return True
        with os.fdopen(fd, "w") as f:
            f.write(str(self.host_id))
        return True

    def _launch(self, pages: np.ndarray, dev: torch.device):
        """Enqueue one chunk on `dev`: host copy into a pinned buffer, the
        copy to the card on a side stream, the pipeline on the device's
        current stream once that copy has landed, the copy back into a
        pinned buffer on a second side stream. Returns (host output
        tensor, event that marks it complete; None on the CPU).

        Returns only once the copy to the card is complete: the source's
        buffer and the pinned input may be reused as soon as this
        returns, while the card still computes the previous chunk."""
        pages = np.ascontiguousarray(pages)
        if dev.type != "cuda":
            # own copy: the source's buffer is overwritten by its next call
            return self.fn(torch.from_numpy(pages.copy())), None
        with torch.cuda.device(dev):
            if dev not in self._streams:
                self._streams[dev] = (torch.cuda.Stream(dev),
                                      torch.cuda.Stream(dev))
            h2d, d2h = self._streams[dev]
            compute = torch.cuda.current_stream(dev)
            src = torch.from_numpy(pages)
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            with torch.cuda.stream(h2d):
                x = pinned.to(dev, non_blocking=True)
                loaded = torch.cuda.Event()
                loaded.record(h2d)
            loaded.synchronize()
            compute.wait_event(loaded)
            x.record_stream(compute)
            out = self.fn(x)
            computed = torch.cuda.Event()
            computed.record(compute)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            d2h.wait_event(computed)
            with torch.cuda.stream(d2h):
                host.copy_(out, non_blocking=True)
                out.record_stream(d2h)
                done = torch.cuda.Event()
                done.record(d2h)
        return host, done

    def _dispatch_chunk(self, start: int, total_pages: int, source,
                        m: BatchMetrics | None = None) -> dict:
        """Load a chunk from the source and enqueue copy + compute on the
        next device. Returns once the chunk is on the card: its compute
        and the copy back run while the host loads the NEXT chunk — the
        pipelined run() keeps one chunk in flight, overlapping the copies
        with compute (SURVEY.md §7 hard-part 5: overlap loading with
        compute).

        Synchronous copy/dispatch failures get the same bounded retry as
        asynchronous ones."""
        n = min(self.chunk_size, total_pages - start)
        idx = np.arange(start, start + n)
        dev = self.devices[self._dispatched % len(self.devices)]
        self._dispatched += 1
        pages = np.asarray(source(idx))
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.perf_counter()
                out, done = self._launch(pages, dev)
                break
            except _RETRYABLE:
                if attempt == self.max_retries:
                    raise
                if m is not None:
                    m.retries += 1
        return {"start": start, "n": n, "idx": idx, "t0": t0, "dev": dev,
                "shape": pages.shape, "out": out, "done": done}

    def _complete_chunk(self, info: dict, source, sink,
                        m: BatchMetrics) -> None:
        """Wait for a dispatched chunk's results, deliver, and record.
        Asynchronous device errors surface here; retries re-fetch the
        chunk from the source (its buffer may have been recycled) and
        re-run it."""
        for attempt in range(self.max_retries + 1):
            try:
                if info["done"] is not None:
                    info["done"].synchronize()
                out = info["out"].numpy()
                break
            except _RETRYABLE:
                if attempt == self.max_retries:
                    raise
                m.retries += 1
                pages = np.asarray(source(info["idx"]))
                info["out"], info["done"] = self._launch(pages, info["dev"])
        dt = time.perf_counter() - info["t0"]
        n = info["n"]
        if sink is not None:
            sink(info["idx"], out[:n])
        self._mark_done(info["start"], n, dt)
        m.pages += n
        m.megapixels += n * info["shape"][1] * info["shape"][2] / 1e6
        m.chunks += 1
        m.chunk_seconds.append(dt)

    def _process_chunk(self, start: int, total_pages: int, source, sink,
                       m: BatchMetrics) -> None:
        """Serial dispatch + complete (used by the steal path)."""
        self._complete_chunk(
            self._dispatch_chunk(start, total_pages, source, m),
            source, sink, m)

    def run(self, total_pages: int, source, sink=None) -> BatchMetrics:
        m = BatchMetrics()
        t_all = time.perf_counter()
        all_starts = list(range(0, total_pages, self.chunk_size))
        # phase 1: this host's own chunks, software-pipelined one deep —
        # chunk i+1's host load and copy to the card run while chunk i
        # computes, and chunk i's copy back and sink run while i+1
        # computes. Peak device memory holds two chunks' in/out buffers;
        # size chunks for it.
        pending = None
        for start in all_starts:
            if start in self._done or self._owner(start) != self.host_id:
                continue
            info = self._dispatch_chunk(start, total_pages, source, m)
            if pending is not None:
                self._complete_chunk(pending, source, sink, m)
            pending = info
        if pending is not None:
            self._complete_chunk(pending, source, sink, m)
        # phase 2 (failure response): steal unfinished chunks from stale
        # hosts; wait on live peers until the whole batch is complete
        while self.heartbeat is not None and self.n_hosts > 1:
            self._reload_done()
            remaining = [s for s in all_starts if s not in self._done]
            if not remaining:
                break
            stale = set(self.heartbeat.stale_hosts())
            stole = False
            for start in remaining:
                if self._owner(start) in stale and self._claim(start):
                    self._process_chunk(start, total_pages, source, sink, m)
                    m.stolen += 1
                    stole = True
            if not stole:
                time.sleep(self.steal_poll)
        m.seconds = time.perf_counter() - t_all
        return m
