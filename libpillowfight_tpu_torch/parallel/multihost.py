"""Per-host heartbeats for the batch runner (port of `Heartbeat` in
`libpillowfight_tpu/parallel/multihost.py`).

A lost host surfaces as a stale heartbeat file instead of a silent hang;
`BatchRunner` then steals its unfinished chunks. The file format is the
reference's (`<dir>/host<i>.hb` holding `{"seq", "t"}`), so heartbeats
written by either package are read by the other.
"""

from __future__ import annotations

import json
import os
import threading
import time


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
