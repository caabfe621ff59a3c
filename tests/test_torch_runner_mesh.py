"""The port's `BatchRunner` on a (pages, rows) mesh against the JAX
package's, on the CPU.

Each chunk is padded to the pages axis and placed as `shard_pages` places
it, so the port's runner on `make_mesh(n, rows=r, devices=["cpu"] * n)`
gives the JAX runner's pages on `make_mesh(n, rows=r)` over the virtual
CPU devices of `conftest.py`, bit for bit; manifests written by either
package on a mesh resume under the other; retries, argument errors and a
source that reuses its buffer behave as on one device.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from libpillowfight_tpu.parallel import BatchRunner as JaxRunner
from libpillowfight_tpu.parallel import make_mesh as jax_mesh
from libpillowfight_tpu_torch import io as tio
from libpillowfight_tpu_torch.parallel import (DOCUMENT_CLEANUP, BatchRunner,
                                               make_host_mesh, make_mesh,
                                               normalize_spec, pipeline,
                                               run_pipeline, shard_pages)
from libpillowfight_tpu_torch.parallel.batch import _copy_block
from libpillowfight_tpu_torch.parallel.mesh import _page_blocks
from libpillowfight_tpu_torch.utils.pages import synthetic_pages, text_pages

# one thread for torch: these pages are small, and beside the other
# workers' XLA compiles a thread pool only waits for its own threads
torch.set_num_threads(1)

W = 128


def _pages(n: int, h: int = 96) -> np.ndarray:
    """n distinct dirty pages: each its own speckles and a bar whose row
    follows the page's index."""
    pages = np.concatenate([synthetic_pages(1, h, W, seed=i)
                            for i in range(n)])
    for i in range(n):
        y = 12 + (5 * i) % (h - 24)
        pages[i, y:y + 2, 20:20 + 4 * (i + 1), :3] = 40
    return pages


def _collect(out: dict):
    def sink(idx, pages):
        for i, j in enumerate(idx):
            assert int(j) not in out, f"page {j} delivered twice"
            out[int(j)] = np.array(pages[i])
    return sink


def _cpu_mesh(n: int, rows: int):
    return make_mesh(n, rows=rows, devices=["cpu"] * n)


def _whole(pages, spec=DOCUMENT_CLEANUP) -> np.ndarray:
    return run_pipeline(torch.from_numpy(pages), normalize_spec(spec)).numpy()


# (devices, rows, page height): chunk 3 over 7 pages leaves chunks the
# pages axis does not divide and, on (2, 2), a last chunk of one page,
# shorter than the pages axis; 94 rows do not split evenly over 3 shards
@pytest.mark.parametrize("n,rows,h", [(4, 2, 96), (3, 3, 96), (3, 3, 94)],
                         ids=["2x2", "1x3", "1x3_uneven_rows"])
def test_mesh_runner_bit_identical_to_jax_runner(n, rows, h):
    pages = _pages(7, h)
    got, want = {}, {}
    m = BatchRunner(DOCUMENT_CLEANUP, chunk_size=3,
                    mesh=_cpu_mesh(n, rows)).run(
        7, lambda idx: pages[idx], _collect(got))
    # the reference places an uneven row split nowhere (`device_put`
    # needs H divisible by the rows axis): it runs those pages whole
    ref_mesh = jax_mesh(n, rows=rows) if h % rows == 0 else jax_mesh(1)
    JaxRunner(DOCUMENT_CLEANUP, chunk_size=3, mesh=ref_mesh).run(
        7, lambda idx: pages[idx], _collect(want))
    assert m.pages == 7 and m.chunks == 3
    assert m.megapixels == pytest.approx(7 * h * W / 1e6)
    assert sorted(got) == sorted(want) == list(range(7))
    whole = _whole(pages)
    for j in range(7):
        np.testing.assert_array_equal(got[j], want[j])
        np.testing.assert_array_equal(got[j], whole[j])
    assert (whole != pages).any()


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 3), (3, 2)])
def test_card_placement_blocks_are_shard_pages_shards(grid):
    """The copies the runner makes to and from the cards, driven on CPU
    tensors: each block of the chunk copied out is `shard_pages`' shard,
    contiguous, and the shards copied into the blocks of one buffer give
    the whole batch (rows 94 and pages 7 split unevenly)."""
    batch = torch.from_numpy(_pages(7, 94))
    want = shard_pages(batch, make_mesh(grid[0] * grid[1], rows=grid[1],
                                        devices=["cpu"] * 6)).shards
    blocks = _page_blocks(batch, grid)
    host = torch.zeros_like(batch)
    for idx, block in np.ndenumerate(blocks):
        x = torch.empty_like(block)
        _copy_block(x, block)
        assert torch.equal(x, want[idx]) and x.is_contiguous()
        _copy_block(_page_blocks(host, grid)[idx], x)
    assert torch.equal(host, batch)


def test_config5_spec_on_rows_mesh_matches_one_device_runner():
    """DOCUMENT_CLEANUP then swt (config 5's spec) on (1, 2) row shards
    gives the one-device runner's pages."""
    spec = DOCUMENT_CLEANUP + (("swt", {}),)
    pages = np.concatenate([text_pages(1, 161, 150, seed=s)
                            for s in range(3)])
    got, want = {}, {}
    BatchRunner(spec, chunk_size=2, mesh=_cpu_mesh(2, 2)).run(
        3, lambda idx: pages[idx], _collect(got))
    BatchRunner(spec, chunk_size=2, devices=["cpu"]).run(
        3, lambda idx: pages[idx], _collect(want))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for j in range(3):
        np.testing.assert_array_equal(got[j], want[j])
    assert (want[0] != pages[0]).any()


def _jax_run(manifest, n, source, sink):
    return JaxRunner(DOCUMENT_CLEANUP, chunk_size=4, mesh=jax_mesh(4, rows=2),
                     manifest_path=manifest).run(n, source, sink)


def _torch_run(manifest, n, source, sink):
    return BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, mesh=_cpu_mesh(4, 2),
                       manifest_path=manifest).run(n, source, sink)


@pytest.mark.parametrize("order", ["torch-torch", "jax-torch", "torch-jax"])
def test_mesh_manifest_resumes(tmp_path, order):
    """A run on a (2, 2) mesh killed at chunk 2 by its source, resumed
    on a (2, 2) mesh by the same or the other package: every page is
    delivered once, only what was left is processed the second time, and
    the pages are the chain's."""
    runs = [{"jax": _jax_run, "torch": _torch_run}[k]
            for k in order.split("-")]
    pages = _pages(14)
    manifest = str(tmp_path / "m.jsonl")
    seen = {}

    def dying(idx):
        if idx[0] == 8:
            raise ValueError("source died")
        return pages[idx]

    with pytest.raises(ValueError, match="source died"):
        runs[0](manifest, 14, dying, _collect(seen))
    done = sorted(json.loads(x)["start"] for x in open(manifest))
    assert done == [0] and sorted(seen) == [0, 1, 2, 3]
    loaded = []

    def source(idx):
        loaded.append(int(idx[0]))
        return pages[idx]

    m = runs[1](manifest, 14, source, _collect(seen))
    assert sorted(loaded) == [4, 8, 12] and m.pages == 10
    assert sorted(seen) == list(range(14))
    lines = [json.loads(x) for x in open(manifest)]
    assert all(set(x) == {"start", "n", "dt", "host"} for x in lines)
    assert sorted(x["start"] for x in lines) == [0, 4, 8, 12]
    assert [x["n"] for x in sorted(lines, key=lambda x: x["start"])] == \
        [4, 4, 4, 2]
    whole = _whole(pages)
    for j in range(14):
        np.testing.assert_array_equal(seen[j], whole[j])


def test_mesh_runner_retries_a_shard_runtime_error_only(monkeypatch):
    """A RuntimeError in one shard's conversion (chunk 1, its second of
    four shards) reruns the chunk; a ValueError is not retried."""
    pages = _pages(8)
    calls = []
    to_words = pipeline.pages_to_words

    def flaky(x):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("transient device failure")
        return to_words(x)

    monkeypatch.setattr(pipeline, "pages_to_words", flaky)
    seen = {}
    m = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4,
                    mesh=_cpu_mesh(4, 2)).run(8, lambda idx: pages[idx],
                                              _collect(seen))
    assert m.retries == 1 and m.pages == 8 and len(calls) == 10
    whole = _whole(pages)
    for j in range(8):
        np.testing.assert_array_equal(seen[j], whole[j])

    def broken(x):
        calls.append(1)
        raise ValueError("a programming error")

    monkeypatch.setattr(pipeline, "pages_to_words", broken)
    calls.clear()
    with pytest.raises(ValueError, match="a programming error"):
        BatchRunner(DOCUMENT_CLEANUP, chunk_size=4,
                    mesh=_cpu_mesh(4, 2)).run(8, lambda idx: pages[idx])
    assert len(calls) == 1  # not retried


def test_mesh_runner_argument_errors(monkeypatch):
    with pytest.raises(ValueError, match="not both"):
        BatchRunner(DOCUMENT_CLEANUP, mesh=_cpu_mesh(2, 2), devices=["cpu"])
    with pytest.raises(ValueError, match="'host', 'chip'"):
        BatchRunner(DOCUMENT_CLEANUP, mesh=make_host_mesh())
    runner = BatchRunner(DOCUMENT_CLEANUP, devices=["cpu", "cpu"])
    assert runner.mesh.devices.shape == (2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRunner(DOCUMENT_CLEANUP)


@pytest.mark.parametrize("spec", [DOCUMENT_CLEANUP, ()],
                         ids=["cleanup", "empty"])
@pytest.mark.parametrize("kind", ["one_buffer", "image_source"])
def test_mesh_runner_reused_source_buffer(tmp_path, spec, kind):
    """A source that hands out views of one buffer it overwrites on each
    call (as `ImagePageSource` does) gives, on a (2, 2) mesh, the pages
    of the whole batch at once. The empty spec returns its input, so a
    runner that kept the source's buffer would deliver the next chunk's
    pages."""
    pages = _pages(11)
    h = pages.shape[1]
    reused = {}
    if kind == "one_buffer":
        buf = np.empty((3, h, W, 4), np.uint8)

        def source(idx):
            buf[:len(idx)] = pages[idx]
            return buf[:len(idx)]

        BatchRunner(spec, chunk_size=3, mesh=_cpu_mesh(4, 2)).run(
            11, source, _collect(reused))
    else:
        paths = []
        for i, page in enumerate(pages):
            paths.append(str(tmp_path / f"p{i}.ppm"))
            tio.write_ppm(paths[-1], page)
        with tio.ImagePageSource(paths, shape=(h, W)) as src:
            BatchRunner(spec, chunk_size=3, mesh=_cpu_mesh(4, 2)).run(
                11, src, _collect(reused))
            assert src.failed == 0
    assert sorted(reused) == list(range(11))
    np.testing.assert_array_equal(np.stack([reused[j] for j in range(11)]),
                                  _whole(pages, spec))


def test_signature_follows_the_reference():
    """The reference's parameters in its order, with its defaults;
    `devices` the only one added, keyword-only, last."""
    want = list(inspect.signature(JaxRunner).parameters.values())
    got = list(inspect.signature(BatchRunner).parameters.values())
    assert [(p.name, p.kind, p.default) for p in got[:-1]] == \
        [(p.name, p.kind, p.default) for p in want]
    assert (got[-1].name, got[-1].kind, got[-1].default) == \
        ("devices", inspect.Parameter.KEYWORD_ONLY, None)
