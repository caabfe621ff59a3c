"""The multi-device dry run (port of `__graft_entry__.dryrun_multichip`).

Three checks on the port's mesh, each held to the unsharded port on the
mesh's first device:

1. the cleanup chain with pages over the pages axis and each page's rows
   over the rows axis (`spatial.py`), bit-identical;
2. `map_sharded_pages` on a pages-only mesh, each device running the
   whole chain on its pages, bit-identical;
3. `sharded_stencil` of `gaussian_on_matrix` (sigma 2, 5 stddev) at halo
   10, within 1e-3 (the reference's bar).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gaussian import gaussian_on_matrix
from . import spatial
from .halo import sharded_stencil
from .mesh import make_mesh, map_sharded_pages, shard_pages
from .pipeline import DOCUMENT_CLEANUP, normalize_spec, run_pipeline

STENCIL_ATOL = 1e-3


def tiny_batch(b: int = 2, h: int = 96, w: int = 128) -> np.ndarray:
    """uint8 RGBA [b,h,w,4]: a content block, a black scan border and 20
    specks (the page of `__graft_entry__._tiny_batch`, same seed)."""
    rng = np.random.default_rng(0)
    pages = np.full((b, h, w, 4), 255, np.uint8)
    pages[:, 30:60, 20:100, :3] = 20
    pages[:, :, :8, :3] = 0
    noise_y = rng.integers(5, h - 5, 20)
    noise_x = rng.integers(12, w - 5, 20)
    pages[:, noise_y, noise_x, :3] = 40
    return pages


def _equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what} differs from the unsharded port")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the three checks on the first `n_devices` of `devices` (None:
    every CUDA card; `["cuda:0"] * 4` shards one card four ways). Raises
    on a difference; returns the flood's exchange rounds of check 1 and
    the stencil's largest error."""
    rows = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, rows=rows, devices=devices)
    dev = mesh.devices[0, 0]
    spec = normalize_spec(DOCUMENT_CLEANUP)

    b = max(n_devices // rows, 1) * 2
    pages = torch.from_numpy(tiny_batch(b=b, h=256, w=320)).to(dev)
    out = run_pipeline(shard_pages(pages, mesh), spec).gather(dev)
    _equal(out, run_pipeline(pages, spec), "the rows-sharded chain")
    rounds = list(spatial.flood_rounds)

    dp_mesh = make_mesh(n_devices, rows=1, devices=devices)
    pages_dp = torch.from_numpy(tiny_batch(b=n_devices * 2, h=256,
                                           w=320)).to(dev)
    out = map_sharded_pages(lambda x: run_pipeline(x, spec),
                            dp_mesh)(pages_dp).gather(dev)
    _equal(out, run_pipeline(pages_dp, spec), "map_sharded_pages")

    gray = pages[..., :3].to(torch.float32).mean(dim=-1)
    halo = int(np.ceil(2.0 * 5))  # gaussian sigma=2, 5 stddev
    blur = sharded_stencil(lambda x: gaussian_on_matrix(x, 2.0, 5), mesh,
                           halo)
    got = blur(gray).gather(dev)
    err = float((got - gaussian_on_matrix(gray, 2.0, 5)).abs().max())
    if not err <= STENCIL_ATOL:
        raise AssertionError(f"sharded_stencil off by {err} (bar "
                             f"{STENCIL_ATOL})")
    return {"flood_rounds": rounds, "stencil_max_abs_err": err}
