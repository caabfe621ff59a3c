"""Multi-process execution: distributed init, the ("host", "chip")
mesh, a gather over processes, and per-host heartbeats (port of
`libpillowfight_tpu/parallel/multihost.py`).

A host is one process, joined to the others through `torch.distributed`:
NCCL where the process has a CUDA card, gloo otherwise. Pages are split
over hosts and gathered with a collective; a page's rows stay on one
host's devices, as the reference keeps "collectives inside a page on
ICI". A lost host surfaces as a stale heartbeat file instead of a silent
hang; `BatchRunner` then steals its unfinished chunks. The heartbeat
file format is the reference's (`<dir>/host<i>.hb` holding `{"seq",
"t"}`), so heartbeats written by either package are read by the other.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch
import torch.distributed as dist

from .mesh import Mesh, _device_grid


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """`torch.distributed.init_process_group` over tcp://coordinator
    ("host:port"), NCCL where this process has a CUDA card, gloo
    otherwise. Each argument falls back on the environment that
    `torchrun` sets: WORLD_SIZE, RANK, and MASTER_ADDR with MASTER_PORT.
    Nothing is done for one process or where the group already exists
    (re-initialisation); any other failure raises."""
    n = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    if n == 1 or dist.is_initialized():
        return
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    if coordinator is None:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}", world_size=n, rank=rank)


def make_host_mesh() -> Mesh:
    """("host", "chip") mesh: one row a process (the rank), one column a
    device of it (every CUDA card, else the CPU). Row h lists host h's
    devices as its process names them, hosts being alike; a process
    drives its own row only."""
    n_hosts = dist.get_world_size() if dist.is_initialized() else 1
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            or [torch.device("cpu")])
    return Mesh(_device_grid(devs * n_hosts, (n_hosts, len(devs))),
                ("host", "chip"))


def process_allgather(x: torch.Tensor) -> torch.Tensor:
    """Every process's x concatenated along dim 0 in rank order, on x's
    device (the counterpart of jax's `multihost_utils.process_allgather(x,
    tiled=True)`). The processes' x may differ in dim 0 only. x itself
    where there is one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = x.to(dev).contiguous()
    world = dist.get_world_size()
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([t.shape[0]], device=dev))
    sizes = [int(s) for s in sizes]
    padded = t.new_zeros((max(sizes), *t.shape[1:]))
    padded[:t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat([p[:n] for p, n in zip(parts, sizes)]).to(x.device)


class Heartbeat:
    """Per-host liveness file heartbeat for the batch runner.

    Each host touches `<dir>/host<i>.hb` every `interval` seconds with a
    monotonic sequence number; `stale_hosts` reports hosts whose beat is
    older than `timeout` (the runner retries their chunks elsewhere).
    Uses a shared filesystem. `host_id` and `n_hosts` default to the
    `RANK` and `WORLD_SIZE` environment variables (those
    `torch.distributed` launchers set), else 0 and 1.
    """

    def __init__(self, directory: str, interval: float = 10.0,
                 timeout: float = 60.0, host_id: int | None = None,
                 n_hosts: int | None = None):
        self.dir = directory
        self.interval = interval
        self.timeout = timeout
        self.host_id = (int(os.environ.get("RANK", 0)) if host_id is None
                        else host_id)
        self.n_hosts = (int(os.environ.get("WORLD_SIZE", 1)) if n_hosts is None
                        else n_hosts)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.dir, f"host{pid}.hb")

    def _beat(self, seq: int) -> None:
        tmp = self._path(self.host_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"seq": seq, "t": time.time()}, f)
        os.replace(tmp, self._path(self.host_id))

    def _run(self):
        seq = 0
        self._beat(seq)  # announce liveness immediately
        while not self._stop.wait(self.interval):
            seq += 1
            self._beat(seq)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval)

    def stale_hosts(self) -> list[int]:
        now = time.time()
        stale = []
        for i in range(self.n_hosts):
            try:
                with open(self._path(i)) as f:
                    beat = json.load(f)
                if now - beat["t"] > self.timeout:
                    stale.append(i)
            except (OSError, ValueError):
                stale.append(i)
        return stale
