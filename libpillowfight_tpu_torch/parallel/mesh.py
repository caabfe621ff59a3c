"""Device mesh and page placement (port of `libpillowfight_tpu/parallel/mesh.py`).

A mesh is a grid of `torch.device`s, [pages, rows], driven from one
process as JAX's mesh is driven from one controller: pages shard over the
"pages" axis and, for pages too large for one device, the rows of a page
shard over the "rows" axis (`halo.py`, `spatial.py`). A device may stand
in the grid more than once: `make_mesh(devices=["cuda:0"] * 4)` gives four
shards on one card and `["cpu"] * 8` eight on the CPU, the port's
counterpart of XLA's forced host device count. A copy between the shards
of two cards is a peer copy; between shards of one device it is a plain
copy.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import numpy as np
import torch

PAGES_AXIS = "pages"
ROWS_AXIS = "rows"

_SPATIAL = contextvars.ContextVar("pf_spatial_sharding", default=False)


@contextlib.contextmanager
def spatial_sharding():
    """Mark the enclosed calls as rows-sharded. The reference fences its
    Pallas band kernels off inside this context, since GSPMD cannot
    partition them; the port fences no kernel off: every row shard runs
    its kernels on its own rows (`spatial.py`). Kept as the same marker."""
    tok = _SPATIAL.set(True)
    try:
        yield
    finally:
        _SPATIAL.reset(tok)


def in_spatial_sharding() -> bool:
    return _SPATIAL.get()


def device_scope(dev: torch.device):
    """Make `dev` the current CUDA device for the enclosed calls (the
    kernels launch on the current device's stream); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@dataclass(frozen=True, eq=False)
class Mesh:
    """devices: object array of `torch.device`, one axis a name of
    `axis_names`."""
    devices: np.ndarray
    axis_names: tuple = (PAGES_AXIS, ROWS_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _device_grid(devs: list, shape: tuple) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


def make_mesh(n_devices: int | None = None, rows: int = 1,
              devices=None) -> Mesh:
    """2-D mesh (pages, rows) over the first `n_devices` of `devices`
    (None: every CUDA card; raises where there is none). rows > 1 shards
    the rows of each page."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run "
                               "the plain versions on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs) if n_devices is None else n_devices
    if not 1 <= n <= len(devs):
        raise ValueError(f"{n} devices asked of {len(devs)}")
    if n % rows != 0:
        raise ValueError(f"{n} devices not divisible by rows={rows}")
    return Mesh(_device_grid(devs[:n], (n // rows, rows)))


@dataclass(frozen=True)
class Placement:
    """Where a batch lives on a mesh: `spec[i]` names the mesh axis that
    dimension i is split over; () is a value every device holds whole."""
    mesh: Mesh
    spec: tuple


def page_sharding(mesh: Mesh) -> Placement:
    """A [B, H, W, ...] page batch: B over pages, H over rows."""
    return Placement(mesh, (PAGES_AXIS, ROWS_AXIS))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def _bounds(n: int, parts: int) -> list[int]:
    """Offsets of `parts` blocks of n, the first n % parts one longer
    (`torch.tensor_split`'s rule)."""
    q, r = divmod(n, parts)
    return [i * q + min(i, r) for i in range(parts + 1)]


class ShardedPages:
    """A page batch placed by `page_sharding`: `shards[i, j]` holds pages
    `page_offsets[i]:page_offsets[i+1]`, rows
    `row_offsets[j]:row_offsets[j+1]`, on `mesh.devices[i, j]`. Blocks
    may differ by one page or one row."""

    def __init__(self, shards: np.ndarray, mesh: Mesh):
        self.shards = shards
        self.mesh = mesh
        first = shards[0, 0]
        self.page_offsets = np.cumsum(
            [0] + [s.shape[0] for s in shards[:, 0]]).tolist()
        self.row_offsets = np.cumsum(
            [0] + [s.shape[1] for s in shards[0, :]]).tolist()
        self.shape = (self.page_offsets[-1], self.row_offsets[-1],
                      *first.shape[2:])
        self.dtype = first.dtype

    def map(self, fn) -> "ShardedPages":
        """fn on every shard, each on its device (the current CUDA device
        made its own); fn keeps a shard's pages and rows."""
        out = np.empty_like(self.shards)
        for idx, s in np.ndenumerate(self.shards):
            with device_scope(s.device):
                out[idx] = fn(s)
        return ShardedPages(out, self.mesh)

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch on `device` (None: the first shard's)."""
        dev = self.shards[0, 0].device if device is None else device
        return torch.cat([torch.cat([s.to(dev) for s in row], dim=1)
                          for row in self.shards], dim=0)


def _page_blocks(pages: torch.Tensor, shape: tuple) -> np.ndarray:
    """Views of a page batch's blocks on a (pages, rows) grid of `shape`:
    block [i, j] holds the i-th run of pages and the j-th run of rows,
    runs split by `_bounds`."""
    pb, rb = _bounds(pages.shape[0], shape[0]), _bounds(pages.shape[1],
                                                        shape[1])
    grid = np.empty(shape, dtype=object)
    for i, j in np.ndindex(*shape):
        grid[i, j] = pages[pb[i]:pb[i + 1], rb[j]:rb[j + 1]]
    return grid


def shard_pages(pages, mesh: Mesh) -> ShardedPages:
    """Place a page batch [B, H, ...] on the mesh: B over the pages axis,
    H over the rows axis, each shard a contiguous copy on its device. H
    need not divide evenly."""
    pages = torch.as_tensor(pages)
    n_p, n_r = mesh.devices.shape
    if pages.ndim < 3 or pages.shape[0] < n_p or pages.shape[1] < n_r:
        raise ValueError(f"pages {tuple(pages.shape)} do not fill a "
                         f"({n_p}, {n_r}) mesh")
    shards = np.empty((n_p, n_r), dtype=object)
    for idx, block in np.ndenumerate(_page_blocks(pages, (n_p, n_r))):
        shards[idx] = block.to(mesh.devices[idx], copy=True,
                               memory_format=torch.contiguous_format)
    return ShardedPages(shards, mesh)


def map_sharded_pages(fn, mesh: Mesh):
    """Data-parallel page map: the returned function runs `fn` on each
    device's page shard, the whole per-page program with its kernels, and
    returns a ShardedPages. It takes a batch or a ShardedPages. The rows
    axis must be size 1: rows-sharded execution goes through
    `run_pipeline` on a ShardedPages (`spatial.py`)."""
    if mesh.shape[ROWS_AXIS] != 1:
        raise ValueError("map_sharded_pages needs a pages-only mesh")

    def run(pages) -> ShardedPages:
        x = pages if isinstance(pages, ShardedPages) else shard_pages(
            pages, mesh)
        return x.map(fn)

    return run
