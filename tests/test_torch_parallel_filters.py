"""gaussian, sobel, canny, ace and swt on rows-sharded pages: bit for bit
the unsharded port on (1, 2), (1, 3), (1, 4) and (2, 2) CPU meshes with
shards of unequal height, on cases built around the shard boundaries,
and against the JAX package under `spatial_sharding()` on the (4, 2)
virtual mesh at the ROADMAP bars."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
import libpillowfight_tpu_torch as pt
from libpillowfight_tpu.parallel import mesh as jmesh
from libpillowfight_tpu.parallel import pipeline as jpipe
from libpillowfight_tpu_torch.core.bitmap import rgba_to_gray
from libpillowfight_tpu_torch.ops.canny import canny_gradients
from libpillowfight_tpu_torch.ops.canny import canny_edge_mask_from_gradients
from libpillowfight_tpu_torch.parallel import make_mesh, shard_pages, spatial
from libpillowfight_tpu_torch.parallel import spatial_ace, spatial_swt
from libpillowfight_tpu_torch.parallel.mesh import _bounds
from libpillowfight_tpu_torch.utils.pages import (bar_pages, lit_snake_pages,
                                                  text_pages)

torch.set_num_threads(1)

jace = importlib.import_module("libpillowfight_tpu.ops.ace")
tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")
tswt = importlib.import_module("libpillowfight_tpu_torch.ops.swt")

MESHES = [(1, 2), (1, 3), (1, 4), (2, 2)]  # (pages, rows)
FILTERS = {
    "gaussian": ("gaussian", {}),
    "gaussian_s1": ("gaussian", {"sigma": 1.0, "nb_stddev": 3}),
    "sobel": ("sobel", {}),
    "canny": ("canny", {}),
    "ace_shared": ("ace", {"nb_samples": 16}),
    "ace_rolled": ("ace", {"mode": "rolled", "nb_samples": 8}),
    "ace_per_pixel": ("ace", {"mode": "per_pixel", "nb_samples": 12}),
    "swt_0": ("swt", {}),
    "swt_1": ("swt", {"output_type": 1}),
    "swt_2": ("swt", {"output_type": 2}),
}
SMALL_LEN = 24  # swt's max_len in the boundary cases: a 74-row halo


def _mesh(rows: int, pages: int = 1):
    return make_mesh(pages * rows, rows=rows, devices=["cpu"] * (pages * rows))


def _sharded(pages, spec, rows: int, pages_axis: int = 1):
    x = shard_pages(torch.as_tensor(pages), _mesh(rows, pages_axis))
    return pt.run_pipeline(x, pt.normalize_spec(spec)).gather()


@functools.lru_cache(maxsize=None)
def _page() -> np.ndarray:
    """161 rows: shards of 81/80, 54/54/53 and 41/40/40/40 rows; glyph
    rows at 26-50 and 106-130 cross boundaries, a noisy patch the blur
    and ACE see."""
    pages = text_pages(2, 161, 150)
    pages[1, 70:100, 20:60, :3] = np.random.default_rng(3).integers(
        0, 256, (30, 40, 3), dtype=np.uint8)
    return pages


@functools.lru_cache(maxsize=None)
def _unsharded(name: str) -> torch.Tensor:
    return pt.run_pipeline(torch.from_numpy(_page()),
                           pt.normalize_spec([FILTERS[name]]))


@pytest.mark.parametrize("name", sorted(FILTERS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_filter_equals_unsharded(name, mesh):
    got = _sharded(_page(), [FILTERS[name]], mesh[1], mesh[0])
    want = _unsharded(name)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    if name.startswith("swt_0"):
        assert (want[..., 0] == 0).sum() > 500  # letters were found


def test_mixed_spec_and_words():
    """An unpaper group then canny; swt and sobel on words give words."""
    pages = torch.from_numpy(_page())
    spec = pt.normalize_spec([*pt.DOCUMENT_CLEANUP, ("canny", ()),
                              ("unpaper_border", ())])
    assert torch.equal(_sharded(pages, spec, 3),
                       pt.run_pipeline(pages, spec))
    words = pages.view(torch.int32).squeeze(-1)
    for spec in ([("swt", {"output_type": 2})], [("sobel", ())],
                 [("swt", {}), ("unpaper_noisefilter", ())]):
        spec = pt.normalize_spec(spec)
        got = pt.run_pipeline(shard_pages(words, _mesh(4)), spec)
        assert got.dtype == torch.int32
        assert torch.equal(got.gather(), pt.run_pipeline(words, spec))


# --- cases at the boundaries -------------------------------------------------

def _band_page(h: int = 240, w: int = 600) -> np.ndarray:
    """Dark bands 23 px wide and 33 long at eight orientations (every
    22.5 degrees) across every boundary of a (1, 4) split, centred on it
    or 9 rows above or below: their gradients point along all 16 ray
    classes, and their rays, up to 24 px, cross boundaries. A black frame
    keeps canny's peak off the page's edge. A halo of 20 rows gives other
    maps than the page's on this page; 25 rows give the page's."""
    g = np.full((h, w), 245, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for i, b in enumerate(_bounds(h, 4)[1:-1]):
        for a in range(8):
            t = a * np.pi / 8
            cy, cx = b + (-9, 0, 9)[(a + i) % 3], 30 + (w - 60) * a // 7
            u = (yy - cy) * np.sin(t) + (xx - cx) * np.cos(t)
            v = -(yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)
            g[(np.abs(u) <= 16) & (np.abs(v) <= 11)] = 10
    g[:, :5] = g[:, -5:] = g[:5] = g[-5:] = 0
    page = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
    return page[None]


def test_swt_width_maps_rays_of_all_16_classes_cross_boundaries():
    """The maps of each shard's slab, cropped, are the page's maps bit for
    bit; the halo (74 rows at max_len 24) is taller than a shard of the
    (1, 6) split (40 rows)."""
    pages = torch.from_numpy(_band_page())
    gray = rgba_to_gray(pages)
    gx, gy = canny_gradients(gray)
    edges = canny_edge_mask_from_gradients(gx, gy)
    want = tswt.swt_maps(edges, gx, gy, SMALL_LEN)[:2]
    cls = tswt._edge_classes(edges, gx, gy)
    _, _, a_enc = tswt._width_pass(cls, SMALL_LEN)
    anchors = torch.cat([a[(a >> 16) != 0] for a in a_enc.values()])
    assert set(((anchors >> 11) & 31).tolist()) == set(range(16))
    assert spatial_swt.swt_halo(SMALL_LEN) == 74 > 40
    assert spatial_swt.swt_halo(128) == 282
    for rows in (3, 4, 6):
        def split(t):
            return list(torch.tensor_split(t, rows, dim=1))

        got = spatial_swt._width_maps(spatial.Column(split(gray)),
                                      split(edges), split(gx), split(gy),
                                      SMALL_LEN)
        for s in range(2):
            assert torch.equal(torch.cat([m[s] for m in got], dim=1),
                               want[s]), (rows, s)
    for mode in (0, 2):
        spec = [("swt", {"max_len": SMALL_LEN, "output_type": mode})]
        assert torch.equal(_sharded(pages, spec, 6),
                           pt.run_pipeline(pages, pt.normalize_spec(spec)))


def test_swt_letter_across_three_shards_and_its_box():
    """A 12 x 100 bar (a letter) over four shards of 40 rows: its
    component is merged across three boundaries, and its box, drawn in
    each shard's rows, crosses them."""
    p = np.full((1, 160, 200, 4), 255, np.uint8)
    p[:, 30:130, 40:52, :3] = 0
    p[:, 50:90, 120:126, :3] = 0
    pages = torch.from_numpy(p)
    for mode in (0, 2):
        spec = [("swt", {"max_len": SMALL_LEN, "output_type": mode})]
        want = pt.run_pipeline(pages, pt.normalize_spec(spec))
        assert torch.equal(_sharded(pages, spec, 4), want)
        assert spatial_swt.merged_labels[0] > 0
        if mode == 0:
            rows = (want[0, :, 40:52, 0] == 0).any(dim=1).nonzero()
            assert rows.min() < 40 and rows.max() >= 120  # 4 shards
        else:
            assert (want[0, 30:130, 38:54, 1] == 0).sum() > 150


@pytest.mark.parametrize("mode", [0, 2])
def test_swt_run_and_letter_caps_bite_across_shards(mode):
    """max_runs cuts the runs in the middle of the page (the ranks carry
    over from the shards above) and max_letters the boxes."""
    pages = torch.from_numpy(text_pages(1, 240, 300))
    _, dbg = tswt.swt(pages, max_len=SMALL_LEN, return_debug=True)
    n_runs, n_letters = int(dbg["n_runs"][0]), int(dbg["n_letters"][0])
    kw = {"max_len": SMALL_LEN, "output_type": mode,
          "max_runs": n_runs // 2, "max_letters": n_letters // 3}
    assert kw["max_letters"] >= 2
    want = pt.run_pipeline(pages, pt.normalize_spec([("swt", kw)]))
    uncapped = pt.run_pipeline(pages, pt.normalize_spec(
        [("swt", {"max_len": SMALL_LEN, "output_type": mode})]))
    assert not torch.equal(want, uncapped)
    for rows in (3, 4):
        assert torch.equal(_sharded(pages, [("swt", kw)], rows), want)


def test_lit_snake_components_and_faint_hysteresis_cross_every_boundary():
    """SWT's component of the lit snake spans every shard (its labels are
    merged); canny's flood on the faint snake takes more exchange rounds
    than there are row shards."""
    pages = torch.from_numpy(lit_snake_pages(1, 257, 330))
    spec = [("swt", {"max_len": SMALL_LEN})]
    assert torch.equal(_sharded(pages, spec, 4),
                       pt.run_pipeline(pages, pt.normalize_spec(spec)))
    assert spatial_swt.merged_labels[0] >= 3
    faint = torch.from_numpy(lit_snake_pages(1, 257, 330, faint=100))
    want = pt.run_pipeline(faint, pt.normalize_spec(pt.EDGE_STACK))
    assert torch.equal(_sharded(faint, pt.EDGE_STACK, 4), want)
    assert spatial.flood_rounds[0] > 4
    assert (want[0, 200:, :, 0] > 0).any()  # the flood reached the far end


def test_ace_samples_on_the_boundary_rows():
    """Shared samples on the first and last rows of every shard give the
    unsharded spray's sums, and a stretch by the page's extrema."""
    pages = torch.from_numpy(_page()[:1])
    for rows in (2, 3, 4):
        b = _bounds(161, rows)
        ys = sorted({y for o, o1 in zip(b, b[1:]) for y in (o, o1 - 1)})
        sy = torch.tensor([ys], dtype=torch.int32)
        sx = torch.arange(len(ys), dtype=torch.int32)[None] * 7
        want = tace.ace_with_samples(pages, sy, sx, 10.0, 1000.0)
        blocks = list(torch.tensor_split(pages, rows, dim=1))
        got = spatial_ace._shared(blocks, sy, sx, 10.0, 1000.0)
        assert torch.equal(torch.cat(got, dim=1), want)


# --- against the JAX package under spatial_sharding() -----------------------

def _jax_spatial(pages: np.ndarray, spec) -> np.ndarray:
    mesh = jmesh.make_mesh(8, rows=2)
    spec = jpipe.normalize_spec(spec)
    with jmesh.spatial_sharding():
        step = jax.jit(lambda x: jpipe.run_pipeline(x, spec),
                       out_shardings=NamedSharding(mesh, P("pages", "rows")))
        return np.asarray(step(jax.device_put(jnp.asarray(pages),
                                              jmesh.page_sharding(mesh))))


def _lsb(got, want):
    return int(np.abs(got.astype(int) - want.astype(int)).max())


@functools.lru_cache(maxsize=None)
def _jax_pages() -> np.ndarray:
    pages = graft._tiny_batch(8, 128, 160)
    pages[:, 80:110, 30:140, :3] = np.random.default_rng(4).integers(
        0, 256, (30, 110, 3), dtype=np.uint8)
    return pages


@pytest.mark.parametrize("name", ["gaussian", "sobel", "canny"])
def test_gradient_stack_matches_jax_spatial_sharding(name):
    """<= 1 LSB for gaussian and sobel, <= 0.1% of edge pixels for canny
    (ROADMAP bars)."""
    pages = _jax_pages()
    want = _jax_spatial(pages, [(name, ())])
    got = _sharded(pages, [(name, ())], 2, pages_axis=4).numpy()
    if name == "canny":
        edges = want[..., 0] > 0
        assert edges.sum() > 500
        assert (got[..., 0] != want[..., 0]).sum() <= 0.001 * edges.sum()
    else:
        assert _lsb(got, want) <= 1


def test_ace_with_samples_matches_jax_on_a_sharded_batch(rng):
    """The same explicit samples through the port's shards and through the
    reference's `ace_with_samples` on its sharded batch: <= 1 LSB."""
    pages = _jax_pages()
    b, h, w, _ = pages.shape
    sy = rng.integers(0, h, (b, 16)).astype(np.int32)
    sy[:, :4] = [0, h // 2 - 1, h // 2, h - 1]  # the boundary rows
    sx = rng.integers(0, w, (b, 16)).astype(np.int32)
    mesh = jmesh.make_mesh(8, rows=2)
    with jmesh.spatial_sharding():
        want = np.asarray(jax.jit(
            lambda x, a, c: jace.ace_with_samples(x, a, c, 10.0, 1000.0))(
            jax.device_put(jnp.asarray(pages), jmesh.page_sharding(mesh)),
            jnp.asarray(sy), jnp.asarray(sx)))
    x = shard_pages(torch.from_numpy(pages), _mesh(2, 4))
    got = np.concatenate([torch.cat(spatial_ace._shared(
        list(col), torch.from_numpy(sy[p0:p0 + col[0].shape[0]]),
        torch.from_numpy(sx[p0:p0 + col[0].shape[0]]), 10.0, 1000.0),
        dim=1).numpy() for col, p0 in zip(x.shards, x.page_offsets)])
    assert _lsb(got, want) <= 1


def test_swt_matches_jax_spatial_sharding():
    """Letter-mask IoU >= 0.99 (ROADMAP bar) against the reference's swt
    partitioned on the (4, 2) mesh, on the bars of its oracle test."""
    pages = bar_pages(4, 96, 128)
    want = _jax_spatial(pages, [("swt", ())])
    got = _sharded(pages, [("swt", ())], 2, pages_axis=4).numpy()
    a, b = got[..., 0] == 0, want[..., 0] == 0
    assert b.sum() > 1000
    assert (a & b).sum() / (a | b).sum() >= 0.99
