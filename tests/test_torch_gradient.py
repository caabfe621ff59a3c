"""The port's gradient stack (conv, gaussian, sobel, canny) vs the JAX
package on the CPU.

Bars (ROADMAP parity bar): gaussian and sobel <= 1 LSB of their uint8
output, canny <= 0.1% of edge pixels differ. Found: the port's plain
order of shifted multiply-adds is the reference's CPU order, and every
case here is bit-identical; the bars are what the port is held to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from libpillowfight_tpu.core import bitmap as jbm
from libpillowfight_tpu.ops import conv as jconv
from libpillowfight_tpu.ops.canny import canny as jcanny
from libpillowfight_tpu.ops.canny import canny_gradients as jcanny_gradients
from libpillowfight_tpu.ops.gaussian import gaussian as jgaussian
from libpillowfight_tpu.ops.pallas.gaussian_kernel import (gaussian_sep_pallas,
                                                           gaussian_taps)
from libpillowfight_tpu.ops.sobel import sobel as jsobel
from libpillowfight_tpu.ops.sobel import sobel_on_matrix as jsobel_on_matrix
from libpillowfight_tpu_torch.core import bitmap as tbm
from libpillowfight_tpu_torch.ops import conv as tconv
from libpillowfight_tpu_torch.ops.canny import (canny as tcanny,
                                                canny_edge_mask,
                                                canny_gradients)
from libpillowfight_tpu_torch.ops.cuda import gaussian as tgauss
from libpillowfight_tpu_torch.ops.gaussian import gaussian as tgaussian
from libpillowfight_tpu_torch.ops.sobel import sobel as tsobel
from libpillowfight_tpu_torch.ops.sobel import sobel_on_matrix


def _planes(rng, n=2, h=37, w=53):
    return (rng.random((n, h, w)) * 255).astype(np.float32)


@pytest.mark.parametrize("name,kernel", [
    ("conv2d", "asym3x5"), ("correlate2d", "asym3x5"),
    ("correlate2d", "sobel_gx"), ("conv2d", "sobel_gy")])
def test_conv_vs_jax(rng, name, kernel):
    """Same taps, same order: bit-identical to the reference's eager
    shifted multiply-adds."""
    x = _planes(rng)
    k = {"asym3x5": rng.standard_normal((3, 5)).astype(np.float32),
         "sobel_gx": jconv.SOBEL_GX, "sobel_gy": jconv.SOBEL_GY}[kernel]
    want = np.asarray(getattr(jconv, name)(jnp.asarray(x), k))
    got = getattr(tconv, name)(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma,nb", [(2.0, 5), (0.8, 3)])
def test_sep_conv2d_and_taps_vs_jax(rng, sigma, nb):
    x = _planes(rng)
    k = tconv.gaussian_kernel_1d(sigma, nb)
    np.testing.assert_array_equal(k, jconv.gaussian_kernel_1d(sigma, nb))
    np.testing.assert_array_equal(
        np.asarray(tconv.gaussian_taps(sigma, nb), np.float32), k)
    assert tconv.gaussian_taps(sigma, nb) == gaussian_taps(sigma, nb)
    want = np.asarray(jconv.sep_conv2d(jnp.asarray(x), k))
    got = tconv.sep_conv2d(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma,nb,shape", [(2.0, 5, (2, 150, 170)),
                                            (0.8, 3, (1, 64, 130))])
def test_blur_plain_vs_pallas(rng, sigma, nb, shape):
    """The blur kernel's plain version vs `gaussian_sep_pallas` in
    interpret mode. Tolerance 1e-4 absolute on [0,255] planes: the TPU
    kernel runs the vertical pass first, the plain version (like the
    reference's CPU path and the CUDA kernel) the horizontal one, so the
    f32 sums round in another order (measured ~6e-5)."""
    x = (rng.random(shape) * 255).astype(np.float32)
    taps = gaussian_taps(sigma, nb)
    want = np.asarray(gaussian_sep_pallas(jnp.asarray(x), taps,
                                          interpret=True))
    got = tgauss.gaussian_sep(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _pages(page, which):
    if which == "page":
        return page
    pages = bench._pages(2, 120, 160, seed=5)
    pages[1, 40:80, 30:90, :3] = np.random.default_rng(2).integers(
        0, 256, (40, 60, 3), dtype=np.uint8)   # a noisy photo patch
    return pages


def _lsb(got, want):
    return int(np.abs(got.astype(int) - want.astype(int)).max())


@pytest.mark.parametrize("which", ["page", "batch2"])
@pytest.mark.parametrize("name", ["gaussian", "sobel"])
def test_gaussian_sobel_vs_jax(page, which, name):
    """<= 1 LSB (ROADMAP bar); measured bit-identical."""
    pages = _pages(page, which)
    jf, tf = {"gaussian": (jgaussian, tgaussian),
              "sobel": (jsobel, tsobel)}[name]
    want = np.asarray(jf(jnp.asarray(pages)))
    got = tf(torch.from_numpy(pages))
    assert got.dtype == torch.uint8 and got.shape == pages.shape
    assert _lsb(got.numpy(), want) <= 1
    assert (want != pages).any()


@pytest.mark.parametrize("which", ["page", "batch2"])
def test_canny_vs_jax(page, which):
    """<= 0.1% of edge pixels differ (ROADMAP bar); measured
    bit-identical."""
    pages = _pages(page, which)
    want = np.asarray(jcanny(jnp.asarray(pages)))
    got = tcanny(torch.from_numpy(pages)).numpy()
    assert got.shape == pages.shape and got.dtype == np.uint8
    edges = want[..., 0] > 0
    assert edges.sum() > 50
    assert (got[..., 0] != want[..., 0]).sum() <= 0.001 * edges.sum()
    np.testing.assert_array_equal(got[..., 3], 255)


def test_canny_flat_page_has_no_edges():
    page = np.zeros((1, 40, 48, 4), np.uint8)
    page[..., 3] = 255
    assert not canny_edge_mask(tbm.rgba_to_gray(torch.from_numpy(page))).any()


def test_canny_gradients_and_sobel_matrix_vs_jax(page):
    """The smoothed gradient pair SWT will share, and sobel's intensity
    and direction. Gradients: 1e-3 absolute on [0,255]-scale values (the
    jitted reference may contract multiply-adds into FMAs; measured
    bit-identical here). Direction: 1e-5 rad (torch's atan2 vs XLA's)."""
    gray = tbm.rgba_to_gray(torch.from_numpy(page)[None])
    jgray = jnp.asarray(gray.numpy())
    gx, gy = canny_gradients(gray)
    jgx, jgy = jax.jit(jcanny_gradients)(jgray)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0, atol=1e-3)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), rtol=0, atol=1e-3)
    got = sobel_on_matrix(gray)
    want = jsobel_on_matrix(jgray)
    np.testing.assert_allclose(got.intensity.numpy(),
                               np.asarray(want.intensity), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.direction.numpy(),
                               np.asarray(want.direction), rtol=0, atol=1e-5)


def test_normalize_gray_to_rgba_to_uint8_vs_jax(rng):
    m = (rng.standard_normal((3, 21, 34)) * 300).astype(np.float32)
    m[2] = 7.0  # a flat page maps to 0
    got = tbm.normalize(torch.from_numpy(m)).numpy()
    want = np.asarray(jbm.normalize(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    assert not got[2].any()
    g = (rng.random((2, 9, 11)) * 300 - 20).astype(np.float32)
    g[0, 0, :4] = [0.5, 1.5, 2.5, 254.5]  # half-even ties
    np.testing.assert_array_equal(tbm.gray_to_rgba(torch.from_numpy(g)).numpy(),
                                  np.asarray(jbm.gray_to_rgba(jnp.asarray(g))))
    np.testing.assert_array_equal(tbm.to_uint8(torch.from_numpy(g)).numpy(),
                                  np.asarray(jbm.to_uint8(jnp.asarray(g))))
