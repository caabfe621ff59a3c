"""The algebra of the ACE spray kernel's arithmetic, checked without a
card: `ace_spray_saturating` (the clip as a saturating multiply-add,
num = limit (2 A - invd)) against the plain clip form and against the TPU
kernel in interpret mode, within the bar the kernel itself is held to on
the card (`ACE_SPRAY_RTOL` of the largest possible magnitude of each
output)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops.pallas.ace_kernel import ace_spray_pallas
from libpillowfight_tpu_torch.ops.cuda import ace as tspray

tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

torch.set_num_threads(1)

LIMIT = 1000.0
SLOPES = {"default": 10.0, "steep": 1e5, "shallow": 0.05}


def _inputs(rng, s, h=41, w=67):
    pages = rng.integers(0, 256, (2, h, w, 4), dtype=np.uint8)
    pages[0, :, : w // 2, :3] //= 8  # a dark half: small differences too
    sy = rng.integers(0, h, (2, s)).astype(np.int32)
    sx = rng.integers(0, w, (2, s)).astype(np.int32)
    planar, sval = tace.spray_inputs(torch.from_numpy(pages),
                                     torch.from_numpy(sy),
                                     torch.from_numpy(sx))
    return planar, torch.from_numpy(sy), torch.from_numpy(sx), sval


def _within_bar(got, want, limit):
    """Both outputs within ACE_SPRAY_RTOL of their largest possible
    magnitude: limit * max(invd) for num, max(invd) for invd."""
    top = float(want[1].max())
    err_n = float((got[0] - want[0]).abs().max())
    err_i = float((got[1] - want[1]).abs().max())
    assert err_n <= tspray.ACE_SPRAY_RTOL * limit * top, (err_n, top)
    assert err_i <= tspray.ACE_SPRAY_RTOL * top, (err_i, top)
    return err_n / (limit * top)


@pytest.mark.parametrize("s", [1, 100, 1000])
@pytest.mark.parametrize("slope", list(SLOPES), ids=list(SLOPES))
def test_saturating_form_vs_plain(rng, slope, s):
    """The saturating form against the clip form, at the default slope, a
    steep one (every term with I != v saturated) and a shallow one (none
    saturated), for 1, 100 and 1000 samples; invd bit-identical: on the
    CPU both use the same rsqrt, and rsqrt(max(d2, 1)) is
    min(rsqrt(max(d2, 1e-12)), 1) for integer coordinates."""
    planar, sy, sx, sval = _inputs(rng, s)
    k = SLOPES[slope]
    want = tspray.ace_spray_plain(planar, sy, sx, sval, k, LIMIT)
    got = tspray.ace_spray_saturating(planar, sy, sx, sval, k, LIMIT)
    assert torch.equal(got[1], want[1])
    _within_bar(got, want, LIMIT)
    delta = (planar[:, :, :, :, None] - sval[:, :, None, None, :]).abs()
    saturated = (k * delta >= LIMIT)[delta > 0]
    if slope == "steep":
        assert bool(saturated.all())
    if slope == "shallow":
        assert not bool(saturated.any())


@pytest.mark.parametrize("slope", list(SLOPES), ids=list(SLOPES))
def test_saturating_form_vs_pallas(rng, slope):
    """... and against the TPU kernel `_ace_tile_kernel` in interpret
    mode, 100 samples."""
    planar, sy, sx, sval = _inputs(rng, 100)
    k = SLOPES[slope]
    pn, pi = ace_spray_pallas(jnp.asarray(planar.numpy()),
                              jnp.asarray(sy.numpy()), jnp.asarray(sx.numpy()),
                              jnp.asarray(sval.numpy()), k, LIMIT,
                              interpret=True)
    want = (torch.from_numpy(np.array(pn)), torch.from_numpy(np.array(pi)))
    got = tspray.ace_spray_saturating(planar, sy, sx, sval, k, LIMIT)
    _within_bar(got, want, LIMIT)


def test_saturating_form_through_from_spray(rng):
    """The uint8 result from the saturating sums is <= 1 LSB from the one
    from the clip sums (the bar of ACE)."""
    pages = rng.integers(0, 256, (2, 41, 67, 4), dtype=np.uint8)
    sy = torch.from_numpy(rng.integers(0, 41, (2, 100)).astype(np.int32))
    sx = torch.from_numpy(rng.integers(0, 67, (2, 100)).astype(np.int32))
    tp = torch.from_numpy(pages)
    planar, sval = tace.spray_inputs(tp, sy, sx)
    outs = [tace.from_spray(tp, *fn(planar, sy, sx, sval, 10.0, LIMIT), LIMIT)
            for fn in (tspray.ace_spray_plain, tspray.ace_spray_saturating)]
    lsb = int((outs[0].to(torch.int32) - outs[1].to(torch.int32)).abs().max())
    assert lsb <= 1


def test_spray_bar_and_prescaled_rule():
    """One bar for the tests and the run on the card; the kernel's
    shorter form only while |k| * 255 <= 2; a limit of 0 is refused before
    any launch."""
    assert tspray.ACE_SPRAY_RTOL == 1e-5
    assert 10.0 / 2000.0 * 255 <= tspray.PRESCALED_MAX_KI < 1e5 / 2000.0 * 255
    plane = torch.zeros((1, 3, 4, 4))
    idx = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tspray.ace_spray_cuda(plane, idx, idx, torch.zeros((1, 3, 2)), 10.0,
                              0.0)
