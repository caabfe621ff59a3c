"""Plain PyTorch versions of the port's kernels vs the Pallas entries of
the JAX package, run in interpret mode on the CPU (the CUDA kernels
themselves are held against these plain versions by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from libpillowfight_tpu.ops import morph as jmorph
from libpillowfight_tpu.ops.pallas.flood_packed import (flood_reach_packed,
                                                        pack_rows, unpack_rows)
from libpillowfight_tpu.ops.pallas.linecount_kernel import line_counts_pallas
from libpillowfight_tpu.ops.pallas.noise_kernel import (_ball_sweep,
                                                        small_cluster_mask_pallas)
from libpillowfight_tpu_torch.ops import morph as tmorph
from libpillowfight_tpu_torch.ops.cuda import flood_packed as tflood
from libpillowfight_tpu_torch.ops.cuda import linecount as tlc
from libpillowfight_tpu_torch.ops.cuda import noise as tnoise


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
