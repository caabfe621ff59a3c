"""Two processes of the port joined over gloo (the counterpart of
`tests/test_multiprocess.py`): each initialises `torch.distributed`
through `initialize_distributed`, builds the ("host", "chip") mesh, runs
the cleanup chain on its part of the global batch and gathers the result
with a collective; the gathered pages equal the JAX `run_pipeline` on the
whole batch, computed in the test process. The workers import only the
port."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from libpillowfight_tpu.parallel import pipeline as jpipe
from libpillowfight_tpu_torch.parallel import (initialize_distributed,
                                               make_host_mesh,
                                               process_allgather)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the global batch, built the same way in the workers and here: 7 pages,
# so that the hosts hold 4 and 3
_PAGES = r"""
import numpy as np
rng = np.random.default_rng(7)
b, h, w = 7, 96, 160
pages = np.full((b, h, w, 4), 245, np.uint8)
pages[..., 3] = 255
pages[:, :, :8, :3] = 0
for y in range(20, 80, 20):
    pages[:, y : y + 2, 30 : w - 20, :3] = 15
ys = rng.integers(5, h - 5, 25); xs = rng.integers(12, w - 5, 25)
pages[:, ys, xs, :3] = 30
"""

_WORKER = r"""
import os, sys
idx, nproc = int(sys.argv[1]), int(sys.argv[2])
port, outdir = sys.argv[3], sys.argv[4]
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from libpillowfight_tpu_torch.parallel import (
    DOCUMENT_CLEANUP, initialize_distributed, make_host_mesh, make_mesh,
    map_sharded_pages, normalize_spec, process_allgather, run_pipeline)

if idx == 0:
    initialize_distributed(coordinator=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=idx)
else:  # the environment torchrun sets
    os.environ.update(WORLD_SIZE=str(nproc), RANK=str(idx),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    initialize_distributed()
initialize_distributed()  # a second call is tolerated
assert dist.get_world_size() == nproc and dist.get_rank() == idx
assert dist.get_backend() == "gloo"

mesh = make_host_mesh()
assert mesh.axis_names == ("host", "chip") and mesh.devices.shape == (nproc, 1)
exec(open(os.path.join(outdir, "pages.py")).read())
mine = torch.tensor_split(torch.from_numpy(pages), nproc)[idx]
spec = normalize_spec(DOCUMENT_CLEANUP)
local = make_mesh(devices=list(mesh.devices[idx]))
out = map_sharded_pages(lambda x: run_pipeline(x, spec), local)(mine).gather()
gathered = process_allgather(out)
np.save(os.path.join(outdir, f"out{idx}.npy"), gathered.numpy())
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "libpillowfight_tpu"
                or m.startswith("libpillowfight_tpu."))
assert not loaded, loaded
"""


def test_two_process_distributed_pipeline(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    (tmp_path / "worker.py").write_text(_WORKER)
    (tmp_path / "pages.py").write_text(_PAGES)
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(i), "2", str(port),
         str(tmp_path)], env=env, cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    ns = {}
    exec(_PAGES, ns)
    spec = jpipe.normalize_spec(jpipe.DOCUMENT_CLEANUP)
    want = np.asarray(jpipe.run_pipeline(jnp.asarray(ns["pages"]), spec))
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{i}.npy"), want)


def test_one_process_is_left_alone(monkeypatch):
    """One process: no group is made, the mesh is this process's devices
    alone and the gather gives its input back."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    mesh = make_host_mesh()
    assert mesh.axis_names == ("host", "chip")
    assert mesh.devices.shape[0] == 1
    x = torch.arange(6)
    assert process_allgather(x) is x
