"""The unpack's and the ball count's plain versions on the shared edge
cases of `utils/pages.unpack_cases` (at reduced heights), `pack_cases`
and `cert_cases`, against the reference on the CPU. `chip_smoke.py`
holds both kernels to these plain versions, bit for bit, on the same
cases on the card (the unpack's at full height).

The plain unpack bit-identical to the JAX `unpack_rows` (its XLA path on
the CPU) on every unpack case, the unaligned word views included, and
the inverse of the plain pack on every pack case (a uint8 plane comes
back as its non-zero test); the plain ball count at k = 1..15
bit-identical to a direct count, a breadth-first search of at most k
king steps through the mask inside each mask pixel's (2k+1)^2 window,
and at k = 1 to `small_cluster_mask_pallas` in interpret mode (the TPU
kernel `_noise_band_kernel`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops.pallas.flood_packed import unpack_rows
from libpillowfight_tpu.ops.pallas.noise_kernel import (
    small_cluster_mask_pallas)
from libpillowfight_tpu_torch.ops.cuda import flood_packed as tflood
from libpillowfight_tpu_torch.ops.cuda import noise as tnoise
from libpillowfight_tpu_torch.utils.pages import (CERT_CASE_NAMES, cert_cases,
                                                  offset_view, pack_cases,
                                                  unpack_cases)

torch.set_num_threads(1)

UNPACK = {c[0]: c[1:] for c in unpack_cases(reduced=True)}
PACK = {c[0]: c[1:] for c in pack_cases(reduced=True)}
CERT = {c[0]: c[1:] for c in cert_cases()}


def _tensor(plane, offset):
    t = torch.from_numpy(plane)
    return offset_view(t, offset) if offset else t


@pytest.mark.parametrize("name", list(UNPACK))
def test_unpack_plain_cases_vs_xla(name):
    plane, offset = UNPACK[name]
    h = plane.shape[1]
    words = tflood.pack_rows_plain(torch.from_numpy(plane))
    if offset:
        words = offset_view(words, offset)
        assert words.data_ptr() % 16 != 0
    got = tflood.unpack_rows(words, h).numpy()
    want = np.asarray(unpack_rows(jnp.asarray(words.numpy().view(np.uint32)),
                                  h))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plane)


@pytest.mark.parametrize("name", list(PACK))
def test_unpack_inverts_pack(name):
    plane, offset = PACK[name]
    got = tflood.unpack_rows_plain(
        tflood.pack_rows_plain(_tensor(plane, offset)), plane.shape[1])
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), plane != 0)


def _ball_by_search(mask: np.ndarray, k: int) -> np.ndarray:
    """bool [B,H,W]: mask pixels whose ball of at most k king steps
    through the mask, inside their (2k+1)^2 window, has <= k members;
    outside the page is not mask. Only the mask pixels' windows are
    searched."""
    s = 2 * k + 1
    padded = np.pad(mask, ((0, 0), (k, k), (k, k)))
    window = np.lib.stride_tricks.sliding_window_view(padded, (s, s),
                                                      axis=(1, 2))[mask]
    reach = np.zeros(window.shape, bool)
    reach[:, k, k] = True
    for _ in range(k):
        rows = reach.copy()          # the 3 x 3 dilation, rows then columns
        rows[:, 1:] |= reach[:, :-1]
        rows[:, :-1] |= reach[:, 1:]
        grown = rows.copy()
        grown[:, :, 1:] |= rows[:, :, :-1]
        grown[:, :, :-1] |= rows[:, :, 1:]
        reach = grown & window
    out = np.zeros_like(mask)
    out[mask] = reach.sum(axis=(1, 2)) <= k
    return out


@pytest.mark.parametrize("name", CERT_CASE_NAMES)
@pytest.mark.parametrize("k", range(1, tnoise.MAX_K + 1))
def test_ball_plain_cases_vs_search(name, k):
    plane, offset = CERT[name]
    got = tnoise.noise_ball(_tensor(plane, offset), k)
    np.testing.assert_array_equal(got.numpy(), _ball_by_search(plane != 0, k))


@pytest.mark.parametrize("name", CERT_CASE_NAMES)
def test_ball_k1_plain_cases_vs_pallas(name):
    plane, offset = CERT[name]
    mask = plane != 0
    got = tnoise.noise_ball(_tensor(mask, offset), 1)
    want = np.asarray(small_cluster_mask_pallas(jnp.asarray(mask), 1,
                                                interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
