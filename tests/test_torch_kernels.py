"""Plain PyTorch versions of the port's kernels vs the Pallas entries of
the JAX package, run in interpret mode on the CPU (the CUDA kernels
themselves are held against these plain versions by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from libpillowfight_tpu.ops import morph as jmorph
from libpillowfight_tpu.ops.pallas import flood_packed as jpacked
from libpillowfight_tpu.ops.pallas.flood_kernel import (flood_reach_pallas,
                                                        label_components_pallas)
from libpillowfight_tpu.ops.pallas.flood_packed import (flood_reach_packed,
                                                        pack_rows, unpack_rows)
from libpillowfight_tpu.ops.pallas.linecount_kernel import line_counts_pallas
from libpillowfight_tpu.ops.pallas.noise_kernel import (_ball_sweep,
                                                        small_cluster_mask_pallas)
from libpillowfight_tpu_torch.ops import morph as tmorph
from libpillowfight_tpu_torch.ops.cuda import flood_packed as tflood
from libpillowfight_tpu_torch.ops.cuda import flood_sweep as tsweep
from libpillowfight_tpu_torch.ops.cuda import label as tlabel
from libpillowfight_tpu_torch.ops.cuda import linecount as tlc
from libpillowfight_tpu_torch.ops.cuda import noise as tnoise

# one thread for torch: these planes are small, and beside the other
# workers' XLA compiles a thread pool only waits for its own threads
torch.set_num_threads(1)


def test_line_counts_plain_vs_pallas(rng):
    mask = rng.random((2, 203, 317)) < 0.3
    want_r, want_c = line_counts_pallas(jnp.asarray(mask), interpret=True)
    got_r, got_c = tlc.line_counts(torch.from_numpy(mask))
    assert got_r.dtype == torch.float32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("h", [70, 64, 5])
def test_pack_unpack_plain_vs_xla(rng, h):
    x = rng.random((2, h, 130)) < 0.5
    got = tflood.pack_rows(torch.from_numpy(x))
    want = np.asarray(pack_rows(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tflood.unpack_rows(got, h).numpy(),
                                  np.asarray(unpack_rows(jnp.asarray(want), h)))
    np.testing.assert_array_equal(tflood.unpack_rows(got, h).numpy(), x)


def _scan_like(rng, b, h, w):
    mask = rng.random((b, h, w)) < 0.35
    mask[:, :, :9] = True                       # border
    mask[:, 40:43, 5:w - 20] = True             # attached bar
    mask[:, 70:72, 30:w - 30] = True            # line beyond a gap
    mask[:, 72 + 20, :] = False                 # a gap row
    for i in range(min(h, w) - 80):              # long diagonal
        mask[0, 80 + i, i] = True
    seeds = np.zeros_like(mask)
    seeds[:, 50, 3] = True
    seeds[:, h - 3, w - 4] = True
    return seeds, mask


@pytest.mark.parametrize("leap", [1, 3, 20])
def test_flood_plain_vs_pallas(rng, leap):
    seeds, mask = _scan_like(rng, 2, 150, 181)
    want = np.asarray(flood_reach_packed(jnp.asarray(seeds), jnp.asarray(mask),
                                         leap=leap, interpret=True))
    got = tmorph.flood_reach(torch.from_numpy(seeds), torch.from_numpy(mask),
                             leap=leap)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flood_round_cap():
    """A finite max_iters stops after as many rounds as the reference's:
    on a zigzag each round adds about one arm."""
    h, w = 40, 50
    mask = np.zeros((1, h, w), bool)
    for i in range(h // 3):
        mask[0, 3 * i, :] = True
        if 3 * i + 3 < h:
            mask[0, 3 * i: 3 * i + 4, w - 1 if i % 2 == 0 else 0] = True
    seeds = np.zeros_like(mask)
    seeds[0, 0, 0] = True
    sizes = set()
    for it in (2, 4):
        want = np.asarray(flood_reach_packed(jnp.asarray(seeds),
                                             jnp.asarray(mask), max_iters=it,
                                             interpret=True))
        got = tmorph.flood_reach(torch.from_numpy(seeds),
                                 torch.from_numpy(mask), max_iters=it)
        np.testing.assert_array_equal(got.numpy(), want)
        sizes.add(int(want.sum()))
    assert len(sizes) == 2 and max(sizes) < mask.sum()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_small_cluster_plain_vs_pallas(rng, k):
    mask = rng.random((2, 97, 143)) < 0.3
    mask[0, 0, 0:k] = True
    mask[0, 1, :] = False
    mask[1, 96, 143 - k - 1:] = True
    want = np.asarray(small_cluster_mask_pallas(jnp.asarray(mask), k,
                                                interpret=True))
    got = tmorph.small_cluster_mask(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_noise_cert_words(rng):
    """Cert words are aligned to page rows; a k=15 board (j=8, 10 words)
    still gives the exact small-cluster mask."""
    mask = rng.random((1, 70, 66)) < 0.25
    certw, maskw = tnoise.noise_cert(torch.from_numpy(mask), 2, 5)
    np.testing.assert_array_equal(
        tflood.unpack_rows(maskw, 70).numpy(), mask)
    assert not (tflood.unpack_rows(certw, 70).numpy() & ~mask).any()
    want = np.asarray(small_cluster_mask_pallas(jnp.asarray(mask), 15,
                                                interpret=True))
    got = tmorph.small_cluster_mask(torch.from_numpy(mask), 15)
    np.testing.assert_array_equal(got.numpy(), want)


def test_noise_cert_words_k16_matches_jax(rng):
    """k >= 16 runs the reference's bitboard formulation (no kernel in
    either package), where the port used to raise ValueError. On a
    40 x 48 page: the reference's XLA form unrolls 35 words x 8
    directions x 16 steps and compiles slowly at larger sizes."""
    mask = rng.random((2, 40, 48)) < 0.3
    mask[0, 5, 0:17] = True      # a 17-pixel bar (kept), one above
    mask[0, 4, :] = mask[0, 6, :] = False
    mask[1, 30, 0:16] = True     # a 16-pixel bar (wiped)
    mask[1, 29, :] = mask[1, 31, :] = False
    mask[1, 30, 16] = False
    want = np.asarray(jmorph.small_cluster_mask(jnp.asarray(mask), 16))
    got = tmorph.small_cluster_mask(torch.from_numpy(mask), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 5, :17].any() and got[1, 30, :16].all()


def _sizes(mask):
    """Each pixel's 8-connected cluster size (scipy labelling)."""
    out = np.zeros(mask.shape, np.int64)
    for i, m in enumerate(mask):
        lab, _ = scipy.ndimage.label(m, structure=np.ones((3, 3)))
        out[i] = np.bincount(lab.ravel())[lab] * m
    return out


@pytest.mark.parametrize("density", [0.2, 0.4])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_noise_ball_plain_vs_pallas_and_scipy(rng, density, k):
    """The direct ball count's plain version vs `_ball_sweep` in
    interpret mode (the TPU kernel `_noise_band_kernel`), and vs scipy's
    cluster sizes: bit-identical."""
    mask = rng.random((2, 61, 75)) < density
    want = np.asarray(_ball_sweep(jnp.asarray(mask), k, k, None, True))
    got = tnoise.noise_ball(torch.from_numpy(mask), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mask & (_sizes(mask) <= k))
    assert got.any() and (mask & ~got).any()


def test_small_cluster_mask_dispatch(rng):
    """k = 1 takes the ball count and k <= 0 erases nothing; the
    certificate route gives the same k = 1 answer."""
    mask = rng.random((1, 50, 64)) < 0.3
    t = torch.from_numpy(mask)
    np.testing.assert_array_equal(tmorph.small_cluster_mask(t, 1).numpy(),
                                  tnoise.small_cluster_mask_cert(t, 1).numpy())
    assert not tmorph.small_cluster_mask(t, 0).any()


# ------------------------------------------------ labels (label_links)

def _as_jax_links(links):
    """{(dy,dx): bool [B,H,W]} numpy -> the same dict for each side."""
    return ({d: jnp.asarray(v) for d, v in links.items()},
            {d: torch.from_numpy(v) for d, v in links.items()})


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("shape,p", [((1, 48, 64), 0.4), ((2, 80, 150), 0.4)],
                         ids=["blobs", "dense"])
def test_label_components_plain_vs_xla(rng, shape, p, connectivity):
    """Plain `label_components` vs the reference's XLA rounds: labels
    bit-identical (min flat index, background H*W)."""
    mask = rng.random(shape) < p
    want = np.asarray(jmorph.label_components(jnp.asarray(mask),
                                              connectivity=connectivity))
    got = tmorph.label_components(torch.from_numpy(mask), connectivity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~mask] == shape[1] * shape[2]).all()
    assert len(np.unique(got.numpy())) > 10


def test_label_components_plain_vs_pallas(rng):
    """... and vs the TPU kernel `_label_sweep_kernel` in interpret mode,
    on a plane with a winding component that takes many sweeps."""
    mask = rng.random((2, 80, 150)) < 0.4
    mask[1, 2:78, 2:148] = False
    mask[1, 4:76:4, 4:146] = True                 # a zigzag of bars
    for i, y in enumerate(range(4, 72, 4)):
        mask[1, y:y + 5, 145 if i % 2 == 0 else 4] = True
    want = np.asarray(label_components_pallas(jnp.asarray(mask),
                                              interpret=True))
    got = tmorph.label_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, 4:76:4, 4:146] == 4 * 150 + 4).all()


def test_label_components_links_plain_vs_xla(rng):
    """Pairwise links: the two-rows case of the reference's own test,
    then random valid pixels with random links (40% valid, 60% of the
    possible links)."""
    valid = np.ones((1, 3, 8), bool)
    links = {d: np.zeros((1, 3, 8), bool) for d in tlabel.OFFSETS}
    links[(0, 1)][0, 0, 0:3] = True
    links[(0, 1)][0, 2, 4:6] = True
    for join in (False, True):
        if join:
            links[(1, 0)][0, 0, 3] = links[(1, 0)][0, 1, 3] = True
            links[(0, 1)][0, 2, 3] = True
        jl, tl = _as_jax_links(links)
        want = np.asarray(jmorph.label_components_links(jnp.asarray(valid), jl))
        got = tmorph.label_components_links(torch.from_numpy(valid), tl)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[0, 0, 0] == got[0, 2, 4]) == join
    valid = rng.random((2, 60, 90)) < 0.4
    links = {}
    for dy, dx in tlabel.OFFSETS:
        other = np.zeros_like(valid)
        other[:, :60 - dy, max(0, -dx):90 - max(0, dx)] = \
            valid[:, dy:, max(0, dx):90 + min(0, dx)]
        links[(dy, dx)] = valid & other & (rng.random(valid.shape) < 0.6)
    jl, tl = _as_jax_links(links)
    want = np.asarray(jmorph.label_components_links(jnp.asarray(valid), jl))
    got = tmorph.label_components_links(torch.from_numpy(valid), tl).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == 60 * 90).all() and len(np.unique(got)) > 50


def test_label_links_ignores_links_off_the_page_or_to_invalid_pixels():
    """A link that points off the page or at an invalid pixel joins
    nothing (the kernel applies the same rule)."""
    valid = np.ones((1, 3, 4), bool)
    valid[0, 1, 1] = False
    links = {d: np.ones((1, 3, 4), bool) for d in tlabel.OFFSETS}
    links[(1, 0)][:] = links[(1, 1)][:] = links[(1, -1)][:] = False
    got = tmorph.label_components_links(
        torch.from_numpy(valid),
        {d: torch.from_numpy(v) for d, v in links.items()})[0].numpy()
    np.testing.assert_array_equal(
        got, [[0, 0, 0, 0], [4, 12, 6, 6], [8, 8, 8, 8]])
    with pytest.raises(ValueError, match="keys"):
        tmorph.label_components_links(torch.from_numpy(valid), {})


# ------------------------------------------------ sweep flood

def _flood_cases(rng):
    """The five geometries of the reference's own sweep-flood tests."""
    mask = rng.random((2, 96, 200)) < 0.4
    seeds = np.zeros_like(mask)
    seeds[:, 10, 10] = seeds[:, 50, 150] = True
    yield "random", seeds, mask, 1
    mask = np.zeros((1, 300, 140), bool)
    mask[0, :, 70] = True
    mask[0, 5, 70:100] = True
    seeds = np.zeros_like(mask)
    seeds[0, 5, 99] = True
    yield "cross_band_column", seeds, mask, 1
    mask = np.zeros((1, 96, 96), bool)
    mask[0, 0, :] = mask[0, :, -1] = mask[0, -1, :] = True
    mask[0, 2:, 0] = True
    mask[0, 2, 2:94] = True
    seeds = np.zeros_like(mask)
    seeds[0, 0, 0] = True
    yield "spiral", seeds, mask, 1
    mask = np.zeros((1, 64, 256), bool)
    mask[0, 30, :20] = mask[0, 30, -20:] = True
    seeds = np.zeros_like(mask)
    seeds[0, 30, 250] = True
    yield "wrap", seeds, mask, 1
    mask = np.zeros((1, 300, 140), bool)
    mask[0, 10:20, 10:60] = mask[0, 32:40, 10:60] = True
    mask[0, 150:160, 10:60] = mask[0, 34:36, 100:130] = True
    seeds = np.zeros_like(mask)
    seeds[0, 15, 15] = True
    yield "leap20", seeds, mask, 20


@pytest.mark.parametrize("case", range(5), ids=[
    "random", "cross_band_column", "spiral", "wrap", "leap20"])
def test_flood_sweep_plain_vs_pallas(rng, case):
    """Plain `flood_sweep` vs the TPU kernel `_flood_sweep_kernel` in
    interpret mode, and vs the port's packed flood: bit-identical."""
    name, seeds, mask, leap = list(_flood_cases(rng))[case]
    want = np.asarray(flood_reach_pallas(jnp.asarray(seeds), jnp.asarray(mask),
                                         leap=leap, interpret=True))
    ts, tm = torch.from_numpy(seeds), torch.from_numpy(mask)
    got = tsweep.flood_sweep(ts, tm, leap=leap)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    h, w = mask.shape[1:]
    packed = tflood.unpack_rows(tflood.flood_packed(
        tflood.pack_rows(ts & tm), tflood.pack_rows(tm), h, w, leap=leap), h)
    assert torch.equal(got, packed)
    assert want.any() and not want[~mask].any()


def test_flood_sweep_arguments():
    plane = torch.zeros((1, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="leap must be >= 1"):
        tsweep.flood_sweep(plane, plane, leap=0)
    with pytest.raises(ValueError, match="must be"):
        tsweep.flood_sweep(plane, plane[0])
    # a leap past the page is the page's size: everything in reach
    mask = torch.zeros((1, 8, 8), dtype=torch.bool)
    mask[0, 0, 0] = mask[0, 7, 7] = True
    seeds = torch.zeros_like(mask)
    seeds[0, 0, 0] = True
    assert tsweep.flood_sweep(seeds, mask, leap=10_000)[0, 7, 7]
    assert not tsweep.flood_sweep(seeds, mask, leap=6)[0, 7, 7]


def test_flood_sweep_strip_width():
    """Every leap the sweep kernel takes leaves a block columns of its
    own between its two halos, half of the strip up to leap 128."""
    for leap in range(1, tsweep.MAX_LEAP + 1):
        threads = tsweep._threads(leap)
        assert threads in (128, 256, 512, 1024)
        assert threads - 2 * leap >= (threads // 2 if leap <= 128 else 256)
    assert tsweep._threads(20) == 128 and tsweep._threads(70) == 512


def test_packed_fits_equals_reference():
    sizes = [1, 31, 32, 33, 127, 128, 129, 500, 2480, 3508, 4960, 7016]
    for h in sizes:
        for w in sizes:
            assert tmorph.packed_fits(h, w) == jpacked.packed_fits(h, w), (h, w)
    assert tmorph.packed_fits(3508, 2480) and not tmorph.packed_fits(7016, 4960)


def test_flood_reach_dispatch(rng, monkeypatch):
    """`flood_reach` sends a page that passes `packed_fits` to the packed
    flood and any other to the sweep flood, with the same result."""
    calls = []
    real_packed, real_sweep = tmorph.flood_packed, tmorph.flood_sweep
    monkeypatch.setattr(tmorph, "flood_packed", lambda *a, **k: (
        calls.append("packed"), real_packed(*a, **k))[1])
    monkeypatch.setattr(tmorph, "flood_sweep", lambda *a, **k: (
        calls.append("sweep"), real_sweep(*a, **k))[1])
    mask = torch.from_numpy(rng.random((1, 40, 60)) < 0.45)
    seeds = torch.zeros_like(mask)
    seeds[0, 20, 30] = mask[0, 20, 30] = True
    small = tmorph.flood_reach(seeds, mask, leap=2)
    assert calls == ["packed"]
    monkeypatch.setattr(tmorph, "PACKED_LIMIT_BYTES", 100)
    assert not tmorph.packed_fits(40, 60)
    large = tmorph.flood_reach(seeds, mask, leap=2)
    assert calls == ["packed", "sweep"]
    assert torch.equal(small, large) and small.sum() > 1
