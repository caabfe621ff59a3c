"""The blur's and the line counts' plain versions on the shared edge
cases of `utils/pages.blur_cases` and `line_count_cases`, against the
reference on the CPU. `chip_smoke.py` holds both kernels to these plain
versions, bit for bit, on the same cases on the card.

Bars: the line counts bit-identical to `line_counts_pallas` in interpret
mode, on every case; the blur bit-identical to the reference's own fold
(`libpillowfight_tpu/ops/conv.py` `sep_conv2d`), and within 1e-4
absolute of `gaussian_sep_pallas` in interpret mode, which runs the H
pass first, so its f32 sums round in another order. The plain blur is a
chain of whole-plane shifts whose work does not depend on the kernel's
strips and row groups, so it is held to the reference on the cases whose
taps or values differ (21 taps, 1, 3 and 97 taps, taps with zeros, an
infinite pixel, the unaligned view): each new shape costs an eager XLA
compile of the fold. The shapes around the kernel's tiles are held
kernel against plain on the card. Of these cases, three are held to the
fold only: the single tap lies outside the Pallas blur's domain (it
slices a halo of hw >= 1 rows), and on the two planes with an infinite
pixel the Pallas kernel multiplies every tap, also a tap of 0, so
0 x inf gives it NaN where the fold skips the tap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.ops import conv as jconv
from libpillowfight_tpu.ops.pallas.gaussian_kernel import gaussian_sep_pallas
from libpillowfight_tpu.ops.pallas.linecount_kernel import line_counts_pallas
from libpillowfight_tpu_torch.ops.cuda import gaussian as tgauss
from libpillowfight_tpu_torch.ops.cuda import linecount as tlc
from libpillowfight_tpu_torch.utils.pages import (LINE_COUNT_CASE_NAMES,
                                                  blur_cases, line_count_cases,
                                                  offset_view)

torch.set_num_threads(1)

BLUR = {c[0]: c[1:] for c in blur_cases()}
LINES = {c[0]: c[1:] for c in line_count_cases()}
REFERENCE_BLUR_CASES = ("h42_w256", "h40_w60_1tap", "h31_w129_3taps",
                        "h33_w127_97taps", "h64_w130_zero_taps", "inf_pixel",
                        "inf_pixel_zero_taps", "unaligned_view")
PALLAS_BLUR_CASES = tuple(n for n in REFERENCE_BLUR_CASES
                          if "inf" not in n and n != "h40_w60_1tap")


@pytest.mark.parametrize("name", LINE_COUNT_CASE_NAMES)
def test_line_counts_plain_cases(name):
    plane, offset = LINES[name]
    t = torch.from_numpy(plane)
    if offset:
        t = offset_view(t, offset)
    got_r, got_c = tlc.line_counts(t)
    want_r, want_c = line_counts_pallas(jnp.asarray(plane != 0),
                                        interpret=True)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_line_counts_uint8_counts_nonzero_bytes():
    """A uint8 plane counts each non-zero byte once, as the same plane
    as bool does (and as the kernel does)."""
    plane = LINES["uint8_values"][0]
    got = tlc.line_counts_plain(torch.from_numpy(plane))
    want = tlc.line_counts_plain(torch.from_numpy(plane != 0))
    assert int(plane.max()) == 255 and (plane > 1).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", REFERENCE_BLUR_CASES)
def test_blur_plain_cases_vs_reference_fold(name):
    planes, taps, offset = BLUR[name]
    t = torch.from_numpy(planes)
    if offset:
        t = offset_view(t, offset)
    got = tgauss.gaussian_sep(t, taps).numpy()
    k = np.asarray(taps, np.float32)[::-1]  # sep_conv2d flips: correlate
    want = np.asarray(jconv.sep_conv2d(jnp.asarray(planes), k))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PALLAS_BLUR_CASES)
def test_blur_plain_cases_vs_pallas(name):
    planes, taps, _ = BLUR[name]
    got = tgauss.gaussian_sep_plain(torch.from_numpy(planes), taps).numpy()
    want = np.asarray(gaussian_sep_pallas(jnp.asarray(planes), taps,
                                          interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_blur_kernel_instance():
    """The 21-tap instance takes every path's taps; any other count, or
    21 taps with a 0 or a 1 among them, takes the generic one."""
    assert tgauss.kernel_instance(BLUR["h42_w256"][1]) == "hw10"
    for name in ("h40_w60_1tap", "h31_w129_3taps", "h33_w127_97taps",
                 "h64_w130_zero_taps"):
        assert tgauss.kernel_instance(BLUR[name][1]) == "generic"
    taps = list(BLUR["h42_w256"][1])
    assert tgauss.kernel_instance(taps[:20] + [0.0]) == "generic"
    assert tgauss.kernel_instance([1.0] + taps[1:]) == "generic"
