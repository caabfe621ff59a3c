"""The shared edge cases of the exact flood (`utils.pages.flood_cases`):
the plain PyTorch versions of the sweep flood and of the packed flood
against both TPU kernels of the JAX package in interpret mode. The CUDA
kernels are held to the same cases, against these plain versions, by
chip_smoke.py on the card.

A file of its own, so that the test runner can give it to another worker
than the other kernel tests: every case compiles both TPU kernels anew."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops.pallas.flood_kernel import flood_reach_pallas
from libpillowfight_tpu.ops.pallas.flood_packed import flood_reach_packed
from libpillowfight_tpu_torch.ops import morph as tmorph
from libpillowfight_tpu_torch.ops.cuda import flood_sweep as tsweep
from libpillowfight_tpu_torch.utils.pages import FLOOD_CASE_NAMES, flood_cases

torch.set_num_threads(1)  # small planes, beside other workers' compiles


@pytest.mark.parametrize("case", range(len(FLOOD_CASE_NAMES)),
                         ids=FLOOD_CASE_NAMES)
def test_flood_edge_cases_plain_vs_pallas(case):
    """The edge cases the CUDA floods are held to on the card (heights
    around a 32-row band, widths around a strip, gaps of exactly `leap`
    and `leap + 1`, snakes, a ring, no seeds): both plain versions against
    both TPU kernels in interpret mode, bit-identical."""
    name, seeds, mask, leap = flood_cases()[case]
    js, jm = jnp.asarray(seeds), jnp.asarray(mask)
    want = np.asarray(flood_reach_pallas(js, jm, leap=leap, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(flood_reach_packed(js, jm, leap=leap, interpret=True)),
        want)
    ts, tm = torch.from_numpy(seeds), torch.from_numpy(mask)
    np.testing.assert_array_equal(
        tsweep.flood_sweep(ts, tm, leap=leap).numpy(), want)
    assert tmorph.packed_fits(*mask.shape[1:])
    np.testing.assert_array_equal(
        tmorph.flood_reach(ts, tm, leap=leap).numpy(), want)
    assert not want[~mask].any() and want[seeds & mask].all()
    if name.startswith("gaps"):  # joined at `leap`, not at `leap + 1`
        assert want.sum() == 8 and mask.sum() == 12
    if name.startswith("snake"):
        assert (want == mask).all()
    if name == "no_seeds":
        assert not want.any()


def test_flood_packed_seeds_outside_the_mask():
    """Both floods keep the seeds inside the mask themselves."""
    mask = torch.zeros((1, 40, 50), dtype=torch.bool)
    mask[0, 5, 5:20] = True
    seeds = torch.zeros_like(mask)
    seeds[0, 5, 6] = seeds[0, 30, 30] = True
    for fn in (tmorph.flood_reach, tsweep.flood_sweep):
        got = fn(seeds, mask, leap=1)
        assert torch.equal(got, mask)
