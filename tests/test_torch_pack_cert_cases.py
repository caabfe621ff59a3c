"""The pack's and the certificate sweep's plain versions on the shared
edge cases of `utils/pages.pack_cases` and `cert_cases`, against the
reference on the CPU. `chip_smoke.py` holds both kernels to these plain
versions, bit for bit, on the same cases on the card (the pack's at full
height).

Bars: the plain pack bit-identical to the JAX `pack_rows` of the plane's
non-zero test, and a uint8 plane packed as its non-zero test (the
kernel's rule: one bit a non-zero byte); the plain certificates
bit-identical to a direct count, a breadth-first search of at most j
king steps through the mask inside each mask pixel's (2j+1)^2 window,
at j = 1..8 and thresh = 2j+1; the small-cluster mask they imply
bit-identical to `small_cluster_mask_pallas` in interpret mode at k = 3
and 7 (`test_torch_kernels.py` takes k = 1, 2, 4 and 15). The implied
mask is compared, not the words: the reference's `_cert_sweep` writes
words of a padded band, not aligned to the page rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops.pallas.flood_packed import pack_rows
from libpillowfight_tpu.ops.pallas.noise_kernel import (
    small_cluster_mask_pallas)
from libpillowfight_tpu_torch.ops.cuda import flood_packed as tflood
from libpillowfight_tpu_torch.ops.cuda import noise as tnoise
from libpillowfight_tpu_torch.utils.pages import (CERT_CASE_NAMES, cert_cases,
                                                  offset_view, pack_cases)

torch.set_num_threads(1)

PACK = {c[0]: c[1:] for c in pack_cases(reduced=True)}
CERT = {c[0]: c[1:] for c in cert_cases()}
UINT8_PACK_CASES = tuple(n for n in PACK if n.startswith("uint8_values"))


def _tensor(plane, offset):
    t = torch.from_numpy(plane)
    return offset_view(t, offset) if offset else t


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", UINT8_PACK_CASES)
def test_pack_uint8_sets_one_bit_a_nonzero_byte(name):
    """A uint8 plane packs as its non-zero test, as the kernel packs it;
    a value of 2 or 255 sets one bit, not its own bits."""
    plane, _ = PACK[name]
    assert int(plane.max()) == 255 and (plane > 1).any()
    got = tflood.pack_rows_plain(torch.from_numpy(plane))
    want = tflood.pack_rows_plain(torch.from_numpy(plane != 0))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        _words(want), np.asarray(pack_rows(jnp.asarray(plane != 0))))


def test_pack_one_column_values():
    """One column with 2 at row 0 and 255 at row 5 packs to 0x21."""
    plane = np.zeros((1, 32, 1), np.uint8)
    plane[0, 0, 0], plane[0, 5, 0] = 2, 255
    words = _words(tflood.pack_rows_plain(torch.from_numpy(plane)))
    assert int(words[0, 0, 0]) == 0x21


@pytest.mark.parametrize("name", list(PACK))
def test_pack_plain_cases_vs_xla(name):
    plane, offset = PACK[name]
    got = tflood.pack_rows(_tensor(plane, offset))
    want = np.asarray(pack_rows(jnp.asarray(plane != 0)))
    np.testing.assert_array_equal(_words(got), want)


def _certs_by_search(mask: np.ndarray, j: int, thresh: int) -> np.ndarray:
    """bool [B,H,W]: mask pixels whose ball of at most j king steps
    through the mask, inside their (2j+1)^2 window, has >= thresh
    members; outside the page is not mask."""
    s = 2 * j + 1
    padded = np.pad(mask, ((0, 0), (j, j), (j, j)))
    window = np.lib.stride_tricks.sliding_window_view(padded, (s, s),
                                                      axis=(1, 2))
    reach = np.zeros(window.shape, bool)
    reach[..., j, j] = mask
    for _ in range(j):
        grown = reach.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                src = reach[..., max(0, -dy): s - max(0, dy),
                            max(0, -dx): s - max(0, dx)]
                grown[..., max(0, dy): s - max(0, -dy),
                      max(0, dx): s - max(0, -dx)] |= src
        reach = grown & window
    return mask & (reach.sum(axis=(-2, -1)) >= thresh)


@pytest.mark.parametrize("name", CERT_CASE_NAMES)
@pytest.mark.parametrize("j", range(1, tnoise.MAX_J + 1))
def test_cert_plain_cases_vs_search(name, j):
    plane, offset = CERT[name]
    h = plane.shape[1]
    mask = plane != 0
    cert_w, mask_w = tnoise.noise_cert(_tensor(plane, offset), j, 2 * j + 1)
    want = _certs_by_search(mask, j, 2 * j + 1)
    np.testing.assert_array_equal(tflood.unpack_rows(mask_w, h).numpy(), mask)
    np.testing.assert_array_equal(tflood.unpack_rows(cert_w, h).numpy(), want)


def test_bars_have_certificates_exactly_past_k():
    """On the bars, a cluster holds a certificate of k = 2j exactly when
    it has more than k pixels."""
    import scipy.ndimage

    plane, _ = CERT["bars_h60_w330_b2"]
    labels, n = scipy.ndimage.label(plane[0], structure=np.ones((3, 3)))
    sizes = np.bincount(labels.ravel())
    for j in (1, 2, 8):
        cert_w, _ = tnoise.noise_cert(torch.from_numpy(plane), j, 2 * j + 1)
        certs = tflood.unpack_rows(cert_w, plane.shape[1]).numpy()[0]
        held = np.zeros(n + 1, bool)
        held[labels[certs]] = True
        np.testing.assert_array_equal(held[1:], sizes[1:] > 2 * j)


@pytest.mark.parametrize("name", CERT_CASE_NAMES)
@pytest.mark.parametrize("k", [3, 7])
def test_cert_implied_mask_vs_pallas(name, k):
    plane, offset = CERT[name]
    mask = plane != 0
    got = tnoise.small_cluster_mask_cert(_tensor(mask, offset), k)
    want = np.asarray(small_cluster_mask_pallas(jnp.asarray(mask), k,
                                                interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
