"""The port's distribution layer on CPU shards: the mesh, the halo
exchange against the reference's shard_map exchange, `sharded_stencil`
against the reference's, the rows-sharded cleanup chain bit-identical to
the JAX `run_pipeline` and to the unsharded port on edge cases built
around the shard boundaries, `map_sharded_pages` and the dry run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
import libpillowfight_tpu_torch as pt
from libpillowfight_tpu.ops.gaussian import gaussian_on_matrix as j_gaussian
from libpillowfight_tpu.parallel import halo as jhalo
from libpillowfight_tpu.parallel import mesh as jmesh
from libpillowfight_tpu.parallel import pipeline as jpipe
from libpillowfight_tpu_torch.ops.gaussian import gaussian_on_matrix
from libpillowfight_tpu_torch.parallel import (dryrun_multichip,
                                               exchange_halo_rows, make_mesh,
                                               map_sharded_pages, shard_pages,
                                               sharded_stencil, spatial)
from libpillowfight_tpu_torch.parallel.mesh import _bounds
from libpillowfight_tpu_torch.utils.pages import (SNAKE_DARK, snake_pages,
                                                  synthetic_pages)

torch.set_num_threads(1)

CLEANUP = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
BG, DARK, SPECK = 245, 15, 120  # background, dark (< 0.33*255), non-white


def _spec(k: int) -> tuple:
    return pt.normalize_spec(
        [(n, {"intensity": k}) if n == "unpaper_noisefilter" else (n, kw)
         for n, kw in pt.DOCUMENT_CLEANUP])


def _cpu_mesh(rows: int, pages: int = 1):
    return make_mesh(pages * rows, rows=rows, devices=["cpu"] * (pages * rows))


def _sharded(pages: np.ndarray, spec, rows: int, pages_axis: int = 1):
    x = shard_pages(torch.from_numpy(pages), _cpu_mesh(rows, pages_axis))
    return pt.run_pipeline(x, spec).gather()


# --- the mesh and the placement ---------------------------------------------

def test_make_mesh_shapes():
    mesh = _cpu_mesh(2, 4)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("pages", "rows")
    assert mesh.shape == {"pages": 4, "rows": 2}
    one_card = make_mesh(devices=["cuda:0"] * 4, rows=4)
    assert one_card.devices.shape == (1, 4)
    assert set(one_card.devices.flat) == {torch.device("cuda", 0)}
    with pytest.raises(ValueError):
        make_mesh(6, rows=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("b,h,pages,rows", [(4, 8, 4, 2), (5, 257, 2, 3),
                                            (3, 10, 1, 4)])
def test_shard_pages_uneven_and_gather(b, h, pages, rows):
    x = torch.arange(b * h * 6, dtype=torch.int32).reshape(b, h, 6)
    s = shard_pages(x, _cpu_mesh(rows, pages))
    assert s.shape == (b, h, 6) and s.dtype == torch.int32
    assert s.row_offsets == _bounds(h, rows)
    heights = np.diff(s.row_offsets)
    assert heights.max() - heights.min() <= 1
    for (i, j), shard in np.ndenumerate(s.shards):
        assert shard.is_contiguous()
        assert torch.equal(shard, x[s.page_offsets[i]:s.page_offsets[i + 1],
                                    s.row_offsets[j]:s.row_offsets[j + 1]])
    assert torch.equal(s.gather(), x)
    with pytest.raises(ValueError):
        shard_pages(x[:, :rows - 1], _cpu_mesh(rows, pages))


# --- the halo exchange and the stencil --------------------------------------

@pytest.mark.parametrize("halo", [1, 2, 4])
def test_exchange_halo_rows_matches_reference(halo):
    """The reference's ring exchange on the 8-device mesh, [4, 8, 4]
    split (4, 2): shards of 4 rows."""
    x = np.arange(4 * 8 * 4, dtype=np.float32).reshape(4, 8, 4)
    mesh = jmesh.make_mesh(8, rows=2)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("pages",
                                                              "rows")))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda b: jhalo.exchange_halo_rows(b, halo), mesh=mesh,
        in_specs=P("pages", "rows"), out_specs=P("pages", "rows", None)))(xs))
    s = shard_pages(torch.from_numpy(x), _cpu_mesh(2, 4))
    got = np.concatenate([
        torch.cat(exchange_halo_rows(list(column), halo), dim=-2).numpy()
        for column in s.shards])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("halo,rows", [(5, 2), (9, 4), (20, 3), (0, 3)])
def test_exchange_halo_rows_taller_than_a_shard(halo, rows):
    """A halo taller than a shard takes rows from every neighbour it
    spans; rows past the page's edges are zero."""
    x = np.arange(2 * 19 * 3, dtype=np.float32).reshape(2, 19, 3) + 1
    blocks = list(torch.tensor_split(torch.from_numpy(x), rows, dim=1))
    padded = np.pad(x, ((0, 0), (halo, halo), (0, 0)))
    offs = _bounds(19, rows)
    for j, got in enumerate(exchange_halo_rows(blocks, halo)):
        np.testing.assert_array_equal(
            got.numpy(), padded[:, offs[j]: offs[j + 1] + 2 * halo])


def test_sharded_stencil_matches_reference(rng):
    gray = rng.random((4, 128, 128)).astype(np.float32) * 255
    fn = jhalo.sharded_stencil(lambda x: j_gaussian(x, 2.0, 5),
                               jmesh.make_mesh(8, rows=2), 10)
    want = np.asarray(fn(jmesh.shard_pages(jnp.asarray(gray),
                                           jmesh.make_mesh(8, rows=2))))
    g = torch.from_numpy(gray)
    got = sharded_stencil(lambda x: gaussian_on_matrix(x, 2.0, 5),
                          _cpu_mesh(2, 4), 10)(g).gather()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    # ghost rows are zero as the blur's edge is: the same sums
    assert torch.equal(got, gaussian_on_matrix(g, 2.0, 5))


# --- the rows-sharded chain against the JAX run_pipeline ---------------------

PAGES = {"tiny_256x320": lambda: graft._tiny_batch(2, 256, 320),
         "synthetic_301x250": lambda: synthetic_pages(2, 301, 250)}


@functools.lru_cache(maxsize=None)
def _jax_chain(page: str, k: int) -> np.ndarray:
    spec = jpipe.normalize_spec(_spec(k))
    return np.asarray(jpipe.run_pipeline(jnp.asarray(PAGES[page]()), spec))


@pytest.mark.parametrize("rows", [2, 3, 4])
@pytest.mark.parametrize("page,k", [("tiny_256x320", 4),
                                    ("synthetic_301x250", 4),
                                    ("tiny_256x320", 1),
                                    ("synthetic_301x250", 1)])
def test_rows_sharded_chain_matches_jax(page, k, rows):
    """k = 16 (the bitboard path) is held to the unsharded port below
    (`noise_k16`): the reference's chain at k = 16 compiles for over ten
    minutes on the CPU."""
    pages = PAGES[page]()
    got = _sharded(pages, _spec(k), rows, pages_axis=2)
    np.testing.assert_array_equal(got.numpy(), _jax_chain(page, k))


def test_rows_sharded_chain_matches_jax_spatial_sharding():
    """As `__graft_entry__.dryrun_multichip` runs the reference: the chain
    partitioned by GSPMD on a (4, 2) mesh under spatial_sharding()."""
    pages = graft._tiny_batch(8, 256, 320)
    mesh = jmesh.make_mesh(8, rows=2)
    spec = jpipe.normalize_spec(CLEANUP)
    with jmesh.spatial_sharding():
        step = jax.jit(lambda x: jpipe.run_pipeline(x, spec),
                       out_shardings=NamedSharding(mesh, P("pages", "rows")))
        want = np.asarray(step(jax.device_put(jnp.asarray(pages),
                                              jmesh.page_sharding(mesh))))
    with pt.parallel.mesh.spatial_sharding():
        assert pt.parallel.mesh.in_spatial_sharding()
        got = _sharded(pages, CLEANUP, 2, pages_axis=4)
    assert not pt.parallel.mesh.in_spatial_sharding()
    np.testing.assert_array_equal(got.numpy(), want)


# --- edge cases at the shard boundaries, against the unsharded port ---------

def _blank(h: int = 257, w: int = 330) -> np.ndarray:
    pages = np.full((1, h, w, 4), BG, np.uint8)
    pages[..., 3] = 255
    return pages


def _snake(bounds):
    """The snake's blackfilter flood must cross each boundary once an
    arm."""
    p = snake_pages(1, 257, 330)
    return p, {"unpaper_blackfilter": p[0, ..., 0] == SNAKE_DARK}


def _leap_border(bounds):
    """The left border is solid above the first boundary and 3 px wide
    from 20 rows below its end on (reached only by the 20-px leap); on the
    right the thin part starts 21 rows below (never reached)."""
    p = _blank()
    b = bounds[1]
    p[:, :b - 11, :25, :3] = DARK
    p[:, b + 8:, :3, :3] = DARK
    p[:, :b - 11, -25:, :3] = DARK
    p[:, b + 9:, -3:, :3] = DARK
    p[:, 100:104, 60:270, :3] = DARK  # a text line
    reached = np.zeros(p.shape[1:3], bool)
    reached[b + 8:, :3] = True
    kept = np.zeros_like(reached)
    kept[b + 9:, -3:] = True
    return p, {"unpaper_blackfilter": reached, "kept": kept}


def _noise(k: int):
    def make(bounds):
        """Vertical clusters of k and k + 1 pixels (and diagonal ones)
        straddling every boundary."""
        p = _blank()
        small = np.zeros(p.shape[1:3], bool)
        big = np.zeros_like(small)
        for i, b in enumerate(bounds[1:-1]):
            for n, x, plane in ((k, 40, small), (k + 1, 80, big)):
                for d, x0 in ((0, x + 100 * i), (1, x + 100 * i + 20)):
                    for t in range(n):
                        y = b - n // 2 + t
                        plane[y, x0 + d * t] = True
        p[0][small | big, :3] = SPECK
        return p, {"unpaper_noisefilter": small, "kept": big}
    return make


def _blur_gray(bounds):
    """Lonely 3 x 3 specks near each boundary (the blurfilter's), one
    beside a busy block two windows across the boundary, and a light gray
    square straddling each boundary (the grayfilter's)."""
    p = _blank(301, 330)
    for b in bounds[1:-1]:
        p[:, b - 2:b + 1, 40:43, :3] = SPECK
        p[:, b + 1:b + 4, 140:143, :3] = SPECK
        p[:, b + 95:b + 140, 120:170, :3] = SPECK
        p[:, b - 40:b + 40, 220:300, :3] = 200
    p[:, 20:24, 60:300, :3] = DARK
    return p, {}


def _one_shard_content(bounds):
    """Text only in the last shard and a dark band only in the first: the
    masks' and the border's profiles each come from one shard."""
    p = _blank()
    for y in range(bounds[-2] + 10, p.shape[1] - 20, 12):
        p[:, y:y + 3, 60:280, :3] = DARK
    p[:, :12, :, :3] = DARK
    return p, {}


EDGE_CASES = {"snake": _snake, "leap_border": _leap_border,
              "noise_k1": _noise(1), "noise_k4": _noise(4),
              "noise_k16": _noise(16), "blur_gray": _blur_gray,
              "one_shard_content": _one_shard_content}


def _single(name: str, k: int) -> tuple:
    return pt.normalize_spec([(name, {"intensity": k} if name ==
                               "unpaper_noisefilter" else {})])


@pytest.mark.parametrize("rows", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_rows_sharded_edge_cases(case, rows):
    h = 301 if case == "blur_gray" else 257
    pages, expect = EDGE_CASES[case](_bounds(h, rows))
    k = int(case[len("noise_k"):]) if case.startswith("noise_k") else 4
    for name, _ in CLEANUP:
        spec = _single(name, k)
        want = pt.run_pipeline(torch.from_numpy(pages), spec)
        assert torch.equal(_sharded(pages, spec, rows), want), name
        wiped = (want[0, ..., 0] == 255).numpy() & (pages[0, ..., 0] != 255)
        if name in expect:  # the case reaches what it was built for
            assert wiped[expect[name]].all(), name
            if "kept" in expect:
                assert not wiped[expect["kept"]].any(), name
        if case == "snake" and name == "unpaper_blackfilter":
            assert min(spatial.flood_rounds) > 2 * rows
    chain = _spec(k)
    want = pt.run_pipeline(torch.from_numpy(pages), chain)
    assert torch.equal(_sharded(pages, chain, rows), want)


def test_rows_sharded_words_and_black_threshold():
    """Words in give words out; a non-default black_threshold (the
    gray-threaded path unsharded) is held bit for bit too."""
    pages = synthetic_pages(2, 203, 190)
    words = torch.from_numpy(pages).view(torch.int32).squeeze(-1)
    x = shard_pages(words, _cpu_mesh(3))
    got = pt.run_pipeline(x, CLEANUP)
    assert got.dtype == torch.int32
    assert torch.equal(got.gather(), pt.run_pipeline(words, CLEANUP))
    spec = pt.normalize_spec([("unpaper_blackfilter",
                               {"black_threshold": 0.6}),
                              ("unpaper_border", ())])
    assert torch.equal(pt.run_pipeline(x, spec).gather(),
                       pt.run_pipeline(words, spec))


def test_rows_sharded_other_filters_raise():
    x = shard_pages(torch.from_numpy(synthetic_pages(1, 64, 64)),
                    _cpu_mesh(2))
    for spec in (pt.EDGE_STACK, [("ace", {})], [("swt", {})],
                 [("unpaper_border", ()), ("gaussian", ())]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            pt.run_pipeline(x, pt.normalize_spec(spec))


# --- pages only --------------------------------------------------------------

def test_map_sharded_pages_matches_reference():
    """As `tests/test_parallel.py` runs the reference pipeline on a batch
    sharded over pages."""
    pages = np.full((8, 128, 128, 4), 255, np.uint8)
    pages[:, 40:80, 30:100, :3] = 20
    pages[:, :, :10, :3] = 0
    spec = pt.normalize_spec([("unpaper_blackfilter", ()),
                              ("unpaper_border", ())])
    mesh = jmesh.make_mesh(8, rows=1)
    want = np.asarray(jax.jit(lambda x: jpipe.run_pipeline(x, spec))(
        jmesh.shard_pages(jnp.asarray(pages), mesh)))
    run = map_sharded_pages(lambda x: pt.run_pipeline(x, spec),
                            _cpu_mesh(1, 8))
    out = run(torch.from_numpy(pages))
    assert out.shards.shape == (8, 1)
    np.testing.assert_array_equal(out.gather().numpy(), want)
    # a ShardedPages on a pages-only mesh runs any filter per shard
    edges = pt.normalize_spec(pt.EDGE_STACK)
    x = shard_pages(torch.from_numpy(pages[:2]), _cpu_mesh(1, 2))
    assert torch.equal(pt.run_pipeline(x, edges).gather(),
                       pt.run_pipeline(torch.from_numpy(pages[:2]), edges))
    with pytest.raises(ValueError, match="pages-only"):
        map_sharded_pages(lambda x: x, _cpu_mesh(2, 4))


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["stencil_max_abs_err"] <= 1e-3
    assert len(out["flood_rounds"]) == 4
