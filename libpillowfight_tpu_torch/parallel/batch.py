"""Large-batch runner: resumable, metered page processing on a device
mesh (port of `libpillowfight_tpu/parallel/batch.py`).

  * page-index manifest for resume (crash -> rerun skips finished
    chunks); a manifest written by either package resumes under the
    other: same lines, claim files and chunk ownership,
  * each chunk placed on the (pages, rows) mesh as `shard_pages` places
    it, padded to the pages axis: its pages split over the pages axis,
    each page's rows over the rows axis, every shard on its device,
  * structured throughput metrics (pages/sec, MP/s, per-chunk timings),
  * per-chunk retry (transient failure -> bounded re-execution),
  * work stealing from hosts whose heartbeat went stale.

While a profiler runs, each stage of a chunk is a span whose request is
the chunk's start index (`utils.metrics.span`): `runner.source`,
`runner.stage_in` (padding, the pinned copy, issuing the copies to the
cards), `runner.wait_loaded`, `runner.issue` (the pipeline),
`runner.stage_out` (issuing the copies back), `runner.wait_done`,
`runner.sink` and `runner.manifest`.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.metrics import span
from .mesh import (PAGES_AXIS, ROWS_AXIS, ShardedPages, _page_blocks,
                   make_mesh, shard_pages)
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


def _copy_block(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), asynchronous, between a card and pinned memory,
    where one side is a block of a page batch (pages p0:p1, rows r0:r1):
    such a block is contiguous a page, so it goes as one copy a page
    unless it is contiguous whole. A strided copy would be staged through
    a temporary, synchronously."""
    if dst.is_contiguous() and src.is_contiguous():
        dst.copy_(src, non_blocking=True)
    else:
        for d, s in zip(dst, src):
            d.copy_(s, non_blocking=True)


class BatchRunner:
    """Process a large page set through a pipeline in chunks.

    `source(indices) -> uint8 [n, H, W, 4]` supplies pages on demand;
    `sink(indices, pages)` consumes results (host numpy, uint8). The
    manifest file records finished chunk start-indices, making reruns
    resumable.
    """

    def __init__(self, spec, chunk_size: int = 64, mesh=None,
                 manifest_path: str | None = None, max_retries: int = 2,
                 host_id: int = 0, n_hosts: int = 1, heartbeat=None,
                 steal_poll: float = 1.0, *, devices=None):
        """mesh: a (pages, rows) `Mesh` that every chunk is placed on
        (None: `make_mesh()`, every CUDA card on the pages axis; raises
        where there is none). devices: shorthand for
        `make_mesh(devices=devices)`, a pages-only mesh (`["cpu"]` runs
        the plain versions on the CPU); not with mesh.

        host_id/n_hosts partition chunks round-robin across hosts (a
        chunk's owner = chunk_index % n_hosts); `heartbeat` (a
        multihost.Heartbeat over a shared directory) enables the failure
        RESPONSE: after finishing its own chunks, a host steals and
        reprocesses the unfinished chunks of any host whose heartbeat has
        gone stale, and waits on live peers until the whole batch is
        done. Steals are de-duplicated via O_EXCL claim files next to the
        manifest (a claim older than the heartbeat timeout is treated as
        abandoned and re-claimable), so completion is at-least-once."""
        self.spec = normalize_spec(spec)
        self.fn = compile_pipeline(self.spec)
        self.chunk_size = chunk_size
        if mesh is not None and devices is not None:
            raise ValueError("give mesh= or devices=, not both")
        self.mesh = mesh if mesh is not None else make_mesh(devices=devices)
        if tuple(self.mesh.axis_names) != (PAGES_AXIS, ROWS_AXIS):
            raise ValueError(f"BatchRunner needs a mesh of axes "
                             f"{(PAGES_AXIS, ROWS_AXIS)}, got "
                             f"{tuple(self.mesh.axis_names)}")
        self._cuda = all(d.type == "cuda" for d in self.mesh.devices.flat)
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

    def _pad_to_mesh(self, pages: np.ndarray) -> np.ndarray:
        """Pad a chunk to a multiple of the pages axis (last chunk or
        chunk_size not divisible by the mesh) by repeating page 0."""
        pad = -len(pages) % self.mesh.devices.shape[0]
        if pad:
            pages = np.concatenate([pages, np.repeat(pages[:1], pad, 0)])
        return pages

    def _side_streams(self, dev: torch.device) -> tuple:
        if dev not in self._streams:
            self._streams[dev] = (torch.cuda.Stream(dev),
                                  torch.cuda.Stream(dev))
        return self._streams[dev]

    def _launch(self, pages: np.ndarray, start: int):
        """Place one chunk (padded to the mesh here) on the mesh and
        enqueue the pipeline on it.
        On CUDA devices: a host copy of the chunk into a pinned buffer;
        each shard (the pages and rows of `shard_pages`' offsets) copied
        from its block of it to its card on that device's side stream,
        its device's current stream waiting on that copy; the pipeline
        on the shards; each output shard copied back into its block of
        one pinned output buffer on its device's second side stream.
        Returns (host output batch, one completion event a device), or
        (host batch, None) on the CPU.

        Returns only once every copy to a card is complete: the source's
        buffer and the pinned input may be reused as soon as this
        returns, while the cards still compute the previous chunk."""
        if not self._cuda:
            with span("runner.stage_in", request=start):
                # shard_pages copies every shard: the source's buffer is
                # overwritten by its next call
                x = shard_pages(torch.from_numpy(np.ascontiguousarray(
                    self._pad_to_mesh(pages))), self.mesh)
            with span("runner.issue", request=start):
                out = self.fn(x)
            with span("runner.stage_out", request=start):
                return out.gather(torch.device("cpu")), None
        grid = self.mesh.devices
        with span("runner.stage_in", request=start):
            src = torch.from_numpy(np.ascontiguousarray(
                self._pad_to_mesh(pages)))
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            shards = np.empty(grid.shape, dtype=object)
            loaded = []
            for idx, block in np.ndenumerate(_page_blocks(pinned,
                                                          grid.shape)):
                dev = grid[idx]
                h2d, _ = self._side_streams(dev)
                with torch.cuda.device(dev), torch.cuda.stream(h2d):
                    x = torch.empty(block.shape, dtype=block.dtype,
                                    device=dev)
                    _copy_block(x, block)
                    shards[idx] = x
                    loaded.append(torch.cuda.Event())
                    loaded[-1].record(h2d)
        with span("runner.wait_loaded", request=start):
            for ev in loaded:
                ev.synchronize()
            for x, ev in zip(shards.flat, loaded):
                compute = torch.cuda.current_stream(x.device)
                compute.wait_event(ev)
                x.record_stream(compute)
        with span("runner.issue", request=start):
            out = self.fn(ShardedPages(shards, self.mesh))
        # the pipeline keeps each shard's pages and rows
        with span("runner.stage_out", request=start):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            blocks = _page_blocks(host, grid.shape)
            done = {}
            for idx, y in np.ndenumerate(out.shards):
                dev = y.device
                _, d2h = self._side_streams(dev)
                with torch.cuda.device(dev):
                    if dev not in done:
                        computed = torch.cuda.Event()
                        computed.record(torch.cuda.current_stream(dev))
                        d2h.wait_event(computed)
                        done[dev] = torch.cuda.Event()
                    with torch.cuda.stream(d2h):
                        _copy_block(blocks[idx], y)
                        y.record_stream(d2h)
            for dev, ev in done.items():
                with torch.cuda.device(dev):
                    ev.record(self._streams[dev][1])
        return host, list(done.values())

    def _dispatch_chunk(self, start: int, total_pages: int, source,
                        m: BatchMetrics | None = None) -> dict:
        """Load a chunk from the source, pad it to the mesh and enqueue
        copies + compute. Returns once the chunk is on the cards: its
        compute and the copies back run while the host loads the NEXT
        chunk — the pipelined run() keeps one chunk in flight,
        overlapping the copies with compute (SURVEY.md §7 hard-part 5:
        overlap loading with compute).

        Synchronous copy/dispatch failures get the same bounded retry as
        asynchronous ones."""
        n = min(self.chunk_size, total_pages - start)
        idx = np.arange(start, start + n)
        with span("runner.source", request=start):
            pages = np.asarray(source(idx))
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.perf_counter()
                out, done = self._launch(pages, start)
                break
            except _RETRYABLE:
                if attempt == self.max_retries:
                    raise
                if m is not None:
                    m.retries += 1
        return {"start": start, "n": n, "idx": idx, "t0": t0,
                "shape": pages.shape, "out": out, "done": done}

    def _complete_chunk(self, info: dict, source, sink,
                        m: BatchMetrics) -> None:
        """Wait for a dispatched chunk's results, deliver, and record.
        Asynchronous device errors surface here; retries re-fetch the
        chunk from the source (its buffer may have been recycled) and
        re-run it."""
        start = info["start"]
        for attempt in range(self.max_retries + 1):
            try:
                with span("runner.wait_done", request=start):
                    for ev in info["done"] or ():
                        ev.synchronize()
                    out = info["out"].numpy()
                break
            except _RETRYABLE:
                if attempt == self.max_retries:
                    raise
                m.retries += 1
                with span("runner.source", request=start):
                    pages = np.asarray(source(info["idx"]))
                info["out"], info["done"] = self._launch(pages, start)
        dt = time.perf_counter() - info["t0"]
        n = info["n"]
        if sink is not None:
            with span("runner.sink", request=start):
                sink(info["idx"], out[:n])
        with span("runner.manifest", request=start):
            self._mark_done(start, n, dt)
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
