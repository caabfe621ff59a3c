"""The port's 4-connected flood, its 3 x 3 neighbourhood helpers and
`compare` against the JAX package on the CPU: all integer or bool
decisions, so every result is bit-identical. The same numpy arrays go
through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpillowfight_tpu_torch as pt
from libpillowfight_tpu.core import bitmap as jbm
from libpillowfight_tpu.ops import morph as jmorph
from libpillowfight_tpu_torch.core import bitmap as tbm
from libpillowfight_tpu_torch.core import constants as TC
from libpillowfight_tpu_torch.ops import morph as tmorph

torch.set_num_threads(1)  # small planes, beside other workers' compiles


def _staircase(h, w):
    """A diagonal staircase of single pixels: one component under
    8-connectivity, every pixel its own under 4. Page 1 adds a second
    pixel to every step, which joins them under 4 as well."""
    mask = np.zeros((2, h, w), bool)
    steps = np.arange(min(h, w - 1))
    mask[:, steps, steps] = True
    mask[1, steps, steps + 1] = True
    seeds = np.zeros_like(mask)
    seeds[:, 0, 0] = True
    return seeds, mask


def _flood4_planes(rng, name):
    if name == "random_48x64":  # the plane of tests/test_morph.py
        mask = (rng.random((48, 64)) < 0.35)[None]
        seeds = np.zeros_like(mask)
        seeds[0, 10, 10] = seeds[0, 30, 40] = True
        return seeds & mask, mask
    if name == "staircase_40x40":
        return _staircase(40, 40)
    seeds, mask = _staircase(21, 67)  # wider than tall, past the coarse grid
    mask[:, 20, :] = True             # a floor the last step stands on
    return seeds, mask


@pytest.mark.parametrize("name", ["random_48x64", "staircase_40x40",
                                  "staircase_21x67"])
def test_flood_reach_4_connected_vs_jax(rng, name):
    """`flood_reach(connectivity=4)` against the reference's fixed point
    (which also runs its multigrid level on these sizes): bit-identical,
    and what 8-connectivity joins over a diagonal, 4 does not."""
    seeds, mask = _flood4_planes(rng, name)
    want = np.asarray(jmorph.flood_reach(jnp.asarray(seeds),
                                         jnp.asarray(mask), connectivity=4))
    got = tmorph.flood_reach(torch.from_numpy(seeds), torch.from_numpy(mask),
                             connectivity=4)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[~mask].any() and want[seeds & mask].all()
    got8 = tmorph.flood_reach(torch.from_numpy(seeds),
                              torch.from_numpy(mask)).numpy()
    assert (want <= got8).all()
    if name.startswith("staircase"):
        assert want[0].sum() == 1          # the seed alone
        assert got8[0].sum() == mask[0].sum()
        assert (want[1] == mask[1]).all()  # joined by the second pixels


def test_flood_reach_4_connected_caps_and_errors():
    """A cap of one round floods one straight run and its plus-shaped
    neighbours; leap > 1 needs 8-connectivity (the reference asserts so);
    other connectivities raise."""
    mask = torch.zeros((1, 9, 9), dtype=torch.bool)
    mask[0, 4, :] = mask[0, :, 4] = True
    mask[0, 0, :] = True
    seeds = torch.zeros_like(mask)
    seeds[0, 4, 0] = True
    one = tmorph.flood_reach(seeds, mask, connectivity=4, max_iters=1)
    assert bool(one[0, 4].all()) and bool(one[0, :, 4].all())
    assert not bool(one[0, 0, 0])
    full = tmorph.flood_reach(seeds, mask, connectivity=4)
    assert torch.equal(full, mask)
    with pytest.raises(ValueError, match="requires 8-connectivity"):
        tmorph.flood_reach(seeds, mask, connectivity=4, leap=2)
    with pytest.raises(ValueError, match="connectivity must be 4 or 8"):
        tmorph.flood_reach(seeds, mask, connectivity=6)


def _plane(rng, kind):
    if kind == "bool":
        return rng.random((2, 23, 31)) < 0.3
    if kind == "int32":
        return rng.integers(-1000, 1000, (2, 23, 31)).astype(np.int32)
    return (rng.standard_normal((2, 23, 31)) * 50).astype(np.float32)


@pytest.mark.parametrize("kind", ["bool", "int32", "f32"])
@pytest.mark.parametrize("fn", ["dilate8", "dilate4", "erode_min8",
                                "erode_min4"])
def test_neighbourhood_helpers_vs_jax(rng, fn, kind):
    """3 x 3 and plus-shaped max and min on bool, int32 and f32 planes,
    bit-identical to the reference; the page's outside counts as the
    type's lowest value (max) or as `big` (min)."""
    x = _plane(rng, kind)
    big = {"bool": True, "int32": 23 * 31, "f32": 1e9}[kind]
    args = (big,) if fn.startswith("erode") else ()
    want = np.asarray(getattr(jmorph, fn)(jnp.asarray(x), *args))
    got = getattr(tmorph, fn)(torch.from_numpy(x), *args)
    assert got.numpy().dtype == x.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != x).any()


@pytest.mark.parametrize("tolerance", [0, None, 255, 12])
def test_compare_vs_jax(rng, tolerance):
    """`compare` on RGBA pages that differ in places by a little and by
    a lot: counts and diff bitmap bit-identical to the reference; None
    takes the default tolerance."""
    a = rng.integers(0, 256, (2, 37, 53, 4), dtype=np.uint8)
    b = a.copy()
    near = rng.random(a.shape[:3]) < 0.2
    far = rng.random(a.shape[:3]) < 0.1
    b[near] = np.clip(a[near].astype(int) + rng.integers(-12, 13, (near.sum(), 4)),
                      0, 255).astype(np.uint8)
    b[far] = rng.integers(0, 256, (far.sum(), 4), dtype=np.uint8)
    b[1, :5] = a[1, :5]
    b[1, :5, :, 3] ^= 0xFF  # alpha alone never counts
    kw = {} if tolerance is None else {"tolerance": tolerance}
    want_n, want_d = jbm.compare(jnp.asarray(a), jnp.asarray(b), **kw)
    got_n, got_d = pt.compare(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert got_n.dtype == torch.int32 and got_d.dtype == torch.uint8
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert got_d.shape == a.shape and bool((got_d[..., 3] == 255).all())
    if tolerance == 255:
        assert got_n.tolist() == [0, 0] and bool((got_d == 255).all())
    else:
        assert int(got_n.min()) > 0


def test_compare_surface():
    """`compare` is the package's and the bitmap module's; its default
    tolerance is the copied constant; one page goes in unbatched; shapes
    must agree."""
    assert pt.compare is tbm.compare and "compare" in pt.__all__
    assert TC.COMPARE_DEFAULT_TOLERANCE == 0
    page = torch.zeros((5, 6, 4), dtype=torch.uint8)
    other = page.clone()
    other[2, 3, 1] = 1
    n, diff = pt.compare(page, other)
    assert n.shape == () and int(n) == 1
    assert diff[2, 3].tolist() == [0, 1, 0, 255]
    assert diff[0, 0].tolist() == [255, 255, 255, 255]
    with pytest.raises(ValueError, match="one shape"):
        pt.compare(page, other[:4])
