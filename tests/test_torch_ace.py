"""The port's ACE vs the JAX package on the CPU.

torch's generator cannot give jax.random's threefry numbers, so parity
is held through injected samples: the same numpy samples, the offsets
and indices jax.random draws for the reference, each handed to both.
Bar (ROADMAP): <= 1 LSB of the uint8 output. Measured: rolled, per-pixel
and pixel samples bit-identical; shared samples up to 1 LSB on a few
bytes (see test_ace_with_samples_vs_jax). The seeded `ace()` is held to
the reference's own statistical checks (tests/test_ace.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops.pallas.ace_kernel import ace_spray_pallas
from libpillowfight_tpu_torch.ops.cuda import ace as tspray

jace = importlib.import_module("libpillowfight_tpu.ops.ace")
tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

SLOPE, LIMIT = 10.0, 1000.0


@pytest.fixture
def pages(rng, page):
    other = rng.integers(0, 256, page.shape, dtype=np.uint8)
    other[..., 3] = rng.integers(0, 256, page.shape[:2], dtype=np.uint8)
    return np.stack([page, other])


def _lsb(got, want):
    return int(np.abs(got.astype(int) - want.astype(int)).max())


@pytest.mark.parametrize("s", [1, 16])
def test_ace_with_samples_vs_jax(rng, pages, s):
    """<= 1 LSB: the port computes the spray kernel's form (sum of
    clip(.) * rsqrt(d^2), then num / (limit * invd)), as the reference
    does on its accelerator; the reference's CPU path divides by d at
    every sample, which rounds differently (measured: 1 LSB on under 1%
    of bytes at S = 1, bit-identical at S = 16 and 100)."""
    b, h, w, _ = pages.shape
    sy = rng.integers(0, h, (b, s)).astype(np.int32)
    sx = rng.integers(0, w, (b, s)).astype(np.int32)
    want = np.asarray(jace.ace_with_samples(
        jnp.asarray(pages), jnp.asarray(sy), jnp.asarray(sx), SLOPE, LIMIT))
    got = tace.ace_with_samples(torch.from_numpy(pages), torch.from_numpy(sy),
                                torch.from_numpy(sx), SLOPE, LIMIT).numpy()
    assert got.shape == pages.shape
    assert _lsb(got, want) <= 1
    np.testing.assert_array_equal(got[..., 3], pages[..., 3])


def test_spray_plain_vs_pallas(rng, pages):
    """(num, invd) of the spray kernel's plain version vs
    `ace_spray_pallas` in interpret mode, on an odd page shape and 600
    samples (more than the CUDA kernel stages at once). Tolerance: 1e-6
    of the largest |num| and 1e-6 of invd, relative: the same terms in
    the same order, but torch's rsqrt on the CPU is 1/sqrt and XLA's
    may differ by an ulp."""
    pages = pages[:, :71, :133]
    b, h, w, _ = pages.shape
    sy = rng.integers(0, h, (b, 600)).astype(np.int32)
    sx = rng.integers(0, w, (b, 600)).astype(np.int32)
    planar, sval = tace.spray_inputs(torch.from_numpy(pages),
                                     torch.from_numpy(sy), torch.from_numpy(sx))
    num, invd = tspray.ace_spray(planar, torch.from_numpy(sy),
                                 torch.from_numpy(sx), sval, SLOPE, LIMIT)
    pn, pi = ace_spray_pallas(jnp.asarray(planar.numpy()), jnp.asarray(sy),
                              jnp.asarray(sx), jnp.asarray(sval.numpy()),
                              SLOPE, LIMIT, interpret=True)
    pn, pi = np.asarray(pn), np.asarray(pi)
    np.testing.assert_allclose(num.numpy(), pn, rtol=0,
                               atol=1e-6 * np.abs(pn).max())
    np.testing.assert_allclose(invd.numpy(), pi, rtol=1e-6, atol=0)


def test_rolled_vs_jax(pages):
    """The port's rolled estimator with the offsets `_ace_rolled` draws
    from its key (split, then randint [S,B] each), vs `_ace_rolled` with
    that key; S = 13 spans one scan chunk of 10 and a remainder."""
    b, h, w, _ = pages.shape
    s = 13
    key = jax.random.PRNGKey(11)
    ky, kx = jax.random.split(key)
    dys = np.array(jax.random.randint(ky, (s, b), 0, h, dtype=jnp.int32))
    dxs = np.array(jax.random.randint(kx, (s, b), 0, w, dtype=jnp.int32))
    want = np.asarray(jace._ace_rolled(jnp.asarray(pages), key, s, SLOPE,
                                       LIMIT))
    got = tace.ace_rolled(torch.from_numpy(pages), torch.from_numpy(dys),
                          torch.from_numpy(dxs), SLOPE, LIMIT).numpy()
    assert _lsb(got, want) <= 1


def test_pixel_samples_and_per_pixel_vs_jax(rng, pages):
    """Explicit per-pixel indices; then `per_pixel` with the index chunks
    `_ace_per_pixel` draws from its key, vs `_ace_per_pixel`."""
    b, h, w, _ = pages.shape
    idx = rng.integers(0, h * w, (b, h, w, 5)).astype(np.int32)
    want = np.asarray(jace.ace_with_pixel_samples(
        jnp.asarray(pages), jnp.asarray(idx), SLOPE, LIMIT))
    got = tace.ace_with_pixel_samples(torch.from_numpy(pages),
                                      torch.from_numpy(idx), SLOPE,
                                      LIMIT).numpy()
    assert _lsb(got, want) <= 1
    key = jax.random.PRNGKey(3)
    nb = 12  # two chunks of 8
    want = np.asarray(jace._ace_per_pixel(jnp.asarray(pages), key, nb, SLOPE,
                                          LIMIT))
    chunks = [torch.from_numpy(np.array(jax.random.randint(
        k, (b, h, w, 8), 0, h * w, dtype=jnp.int32)))
        for k in jax.random.split(key, 2)]
    got = tace.ace_per_pixel(torch.from_numpy(pages), chunks, SLOPE,
                             LIMIT).numpy()
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("mode", ["shared", "rolled", "per_pixel"])
def test_seeded_ace_statistics(page, mode):
    """The reference's statistical checks (tests/test_ace.py): a constant
    page maps to 128 +- 1, a page is stretched to the full range, the
    same seed gives the same output, a batch keeps its shape."""
    flat = np.full((32, 32, 4), 77, np.uint8)
    flat[..., 3] = 255
    out = tace.ace(torch.from_numpy(flat), nb_samples=8, mode=mode).numpy()
    assert out.shape == flat.shape
    assert np.all(np.abs(out[..., :3].astype(int) - 128) <= 1)
    out = tace.ace(torch.from_numpy(page), nb_samples=32, mode=mode).numpy()
    assert out[..., :3].min() <= 5 and out[..., :3].max() >= 250
    a = tace.ace(torch.from_numpy(page), nb_samples=16, seed=7, mode=mode)
    b = tace.ace(torch.from_numpy(page), nb_samples=16, seed=7, mode=mode)
    assert torch.equal(a, b)
    batch = torch.from_numpy(np.stack([page, page[::-1].copy()]))
    assert tace.ace(batch, nb_samples=16, mode=mode).shape == batch.shape


def test_seeded_shared_draws_sample_coords(page):
    """`ace()` in shared mode is ace_with_samples on the samples that
    `sample_coords` draws from the seed; another seed draws others."""
    h, w, _ = page.shape
    sy, sx = tace.sample_coords(5, 1, 16, h, w)
    assert sy.dtype == torch.int32 and sy.shape == (1, 16)
    assert int(sy.max()) < h and int(sx.max()) < w
    want = tace.ace_with_samples(torch.from_numpy(page)[None], sy, sx,
                                 SLOPE, LIMIT)[0]
    got = tace.ace(torch.from_numpy(page), nb_samples=16, seed=5)
    assert torch.equal(got, want)
    assert not torch.equal(tace.sample_coords(6, 1, 16, h, w)[0], sy)
    with pytest.raises(ValueError, match="unknown ace mode"):
        tace.ace(torch.from_numpy(page), mode="nope")
