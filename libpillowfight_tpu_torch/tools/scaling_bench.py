"""The batch runner in one and in two processes on one shared manifest
(the port's counterpart of the reference's `tools/scaling_bench.py`).

    python -m libpillowfight_tpu_torch.tools.scaling_bench [--quick]
        [--device cuda|cpu] [--out PATH]

The reference sweeps GSPMD virtual devices and `jax.distributed`
processes. Here the runner's hosts share no collective, only the
manifest directory, through `BatchRunner(host_id, n_hosts, heartbeat)`,
each on a one-device mesh. So this runs DOCUMENT_CLEANUP through the
runner over N pages of `utils.pages.synthetic_pages`, chunk C, first as
one process, then as two OS processes (host_id 0 and 1, n_hosts 2) on
one manifest and one `Heartbeat` directory, and records each run's wall
time and pages/s and `parallel_overhead_pct = 100 (T2 - T1) / T1`. It
checks that every page was delivered exactly once across the processes.

Both processes share cuda:0 (with `--device cpu`, the CPU). One card
means this is the overhead of the runner's split, not scaling:
`efficiency_strong_valid` is false, as `SCALING.json` records for its
virtual devices.

Each worker process builds nothing: the kernels are built (or found)
before the workers start. A worker makes its two source batches (two
distinct dirty chunks, made before the clock starts, which the source
hands out in turns), warms up with a run of two chunks without a
manifest (the kernels loaded, the device and pinned memory pools and the
runner's streams primed), starts its heartbeat,
and waits until every worker of the run is ready; the clock of a run
runs from the first worker's start to the last worker's end. The output
is `chiprun_out/scaling_torch.json`. Default on the card: 64 A4 pages,
chunk 16; `--quick`: 8 pages of 512 x 512, chunk 4.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
_MODULE = "libpillowfight_tpu_torch.tools.scaling_bench"
DEFAULT_OUT = "chiprun_out/scaling_torch.json"
FULL = {"pages": 64, "chunk": 16, "h": 3508, "w": 2480}
QUICK = {"pages": 8, "chunk": 4, "h": 512, "w": 512}
WORKER_TIMEOUT_S = 1800


def _worker(cfg: dict) -> None:
    """One host of the runner; writes its result to cfg["result"]."""
    import torch

    from ..parallel import BatchRunner, DOCUMENT_CLEANUP, Heartbeat
    from ..utils.pages import synthetic_pages

    host, n_hosts = cfg["host_id"], cfg["n_hosts"]
    dev = "cuda:0" if cfg["device"] == "cuda" else "cpu"
    if dev == "cpu":
        torch.set_num_threads(1)  # the processes share the host's cores
    chunk, h, w = cfg["chunk"], cfg["h"], cfg["w"]
    bufs = [synthetic_pages(chunk, h, w, seed=s) for s in (0, 1)]
    # warm: the kernels loaded, the device and pinned host memory pools
    # and the runner's side streams primed by a run of two chunks
    BatchRunner(DOCUMENT_CLEANUP, chunk_size=chunk, devices=[dev]).run(
        2 * chunk, lambda idx: bufs[0][:len(idx)])
    heartbeat = Heartbeat(cfg["heartbeat_dir"], interval=1.0, timeout=60.0,
                          host_id=host, n_hosts=n_hosts).start()
    delivered = []

    def source(idx):
        return bufs[(int(idx[0]) // chunk) % 2][:len(idx)]

    def sink(idx, pages):
        if pages.shape != (len(idx), h, w, 4):
            raise AssertionError(f"sink got {pages.shape}")
        delivered.extend(int(i) for i in idx)

    runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=chunk, devices=[dev],
                         manifest_path=cfg["manifest"], host_id=host,
                         n_hosts=n_hosts,
                         heartbeat=heartbeat if n_hosts > 1 else None,
                         steal_poll=0.01)
    ready = Path(cfg["heartbeat_dir"]) / f"ready{host}"
    ready.write_text("")
    while len(list(Path(cfg["heartbeat_dir"]).glob("ready*"))) < n_hosts:
        time.sleep(0.005)
    t0 = time.time()
    m = runner.run(cfg["pages"], source, sink)
    t1 = time.time()
    heartbeat.stop()
    Path(cfg["result"]).write_text(json.dumps({
        "host_id": host, "t_start": t0, "t_end": t1,
        "delivered": delivered, "metrics": m.to_dict(),
        "pages_delivered": len(delivered),
        "chunk_seconds": [round(s, 4) for s in m.chunk_seconds]}))


def _run(n_procs: int, params: dict, device: str, tmp: Path) -> dict:
    """One run of the runner in n_procs processes on one manifest."""
    run_dir = tmp / f"procs{n_procs}"
    run_dir.mkdir()
    procs, results = [], []
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        for host in range(n_procs):
            res = run_dir / f"result{host}.json"
            results.append(res)
            cfg = {**params, "device": device, "host_id": host,
                   "n_hosts": n_procs, "manifest": str(run_dir / "manifest"),
                   "heartbeat_dir": str(run_dir / "hb"), "result": str(res)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _MODULE, "--worker", json.dumps(cfg)],
                cwd=_REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for host, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"worker {host} of {n_procs} exited "
                               f"{p.returncode}:\n{logs[host][-4000:]}")
    hosts = [json.loads(r.read_text()) for r in results]
    delivered = sorted(i for r in hosts for i in r.pop("delivered"))
    if delivered != list(range(params["pages"])):
        raise AssertionError(f"{n_procs} processes delivered "
                             f"{len(delivered)} pages, not each of "
                             f"{params['pages']} once")
    seconds = max(r["t_end"] for r in hosts) - min(r["t_start"] for r in hosts)
    for r in hosts:
        del r["t_start"], r["t_end"]
    return {"n_processes": n_procs, "seconds": seconds,
            "pages_per_s": params["pages"] / seconds,
            "every_page_once": True, "hosts": hosts}


def measure(pages: int, chunk: int, h: int, w: int, device: str = "cuda"
            ) -> dict:
    """The record: DOCUMENT_CLEANUP through the runner over `pages` H x W
    pages, chunk `chunk`, in one and in two processes on `device`
    ("cuda": cuda:0, raises without a card; "cpu")."""
    import torch

    from .. import _build
    from ..utils import metrics

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    rec = {"config": "unpaper_chain_runner_processes", "pages": pages,
           "chunk": chunk, "page_shape": [h, w], "device": device,
           "device_name": "cpu", "power_limit": None,
           "efficiency_strong_valid": False,
           "parallel_overhead_valid": True,
           "note": ("one card (or the CPU) shared by both processes: T2 "
                    "against T1 is the overhead of splitting the runner's "
                    "chunks over two hosts of one manifest, not scaling "
                    "efficiency, which would need a card a host")}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu'")
        rec["device_name"], rec["power_limit"] = metrics.card_name_and_power()
        _build.load()  # build once, before the workers load it
    params = {"pages": pages, "chunk": chunk, "h": h, "w": w}
    with tempfile.TemporaryDirectory(prefix="pft_scaling_") as tmp:
        p1 = _run(1, params, device, Path(tmp))
        p2 = _run(2, params, device, Path(tmp))
    p2["parallel_overhead_pct"] = (100.0 * (p2["seconds"] - p1["seconds"])
                                   / p1["seconds"])
    rec["process_sweep"] = [p1, p2]
    rec["parallel_overhead_pct"] = p2["parallel_overhead_pct"]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="path of the record, relative to the repository")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(json.loads(args.worker))
        return
    rec = measure(**(QUICK if args.quick else FULL), device=args.device)
    path = _REPO / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
