"""Plain PyTorch versions of the port's kernels vs the Pallas entries of
the JAX package, run in interpret mode on the CPU (the CUDA kernels
themselves are held against these plain versions by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops.pallas.flood_packed import (flood_reach_packed,
                                                        pack_rows, unpack_rows)
from libpillowfight_tpu.ops.pallas.linecount_kernel import line_counts_pallas
from libpillowfight_tpu.ops.pallas.noise_kernel import small_cluster_mask_pallas
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
    with pytest.raises(ValueError, match="k=16"):
        tmorph.small_cluster_mask(torch.from_numpy(mask), 16)
