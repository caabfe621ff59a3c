"""The port's façade (`libpillowfight_tpu_torch.compat`) and its
`pillowfight_torch` shim against the JAX package's on the CPU.

All 13 functions on one small page with `device="cpu"`, through PIL, at
the parity bars of ROADMAP.md: bit-identical for the six `unpaper_*` and
`compare`, <= 1 LSB for gaussian and sobel, <= 0.1% of edge pixels for
canny, letter-mask IoU >= 0.99 for swt modes 0 and 1 (on a small page
with glyphs: the `page` fixture has none). ACE's random numbers differ
between the packages, so the façade is held to the port's
`ops.ace(mode="rolled")` bit for bit, to the reference façade's
defaults, and to the reference's statistical checks.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import libpillowfight_tpu.compat as jcompat
import libpillowfight_tpu_torch.compat as tcompat
from libpillowfight_tpu_torch.utils.pages import text_pages

PIL = pytest.importorskip("PIL.Image")

# one thread for torch: these pages are small, and beside the other
# workers' XLA compiles a thread pool only waits for its own threads
torch.set_num_threads(1)

tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

UNPAPER = ("unpaper_blackfilter", "unpaper_noisefilter", "unpaper_blurfilter",
           "unpaper_masks", "unpaper_grayfilter", "unpaper_border")
CANNY_BAR = 0.001
SWT_IOU_BAR = 0.99


def _pil(page):
    return PIL.fromarray(page, mode="RGBA")


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int)
                      - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("name", UNPAPER)
def test_unpaper_vs_jax_facade(page, name):
    img = _pil(page)
    got = getattr(tcompat, name)(img, device="cpu")
    want = getattr(jcompat, name)(img)
    assert got.mode == "RGBA" and got.size == img.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_compare_vs_jax_facade(page):
    img = _pil(page)
    other = page.copy()
    other[40:60, 50:90, :3] = 128
    other[::7, ::5, 0] += 1  # within the default tolerance
    n, diff = tcompat.compare(img, _pil(other), device="cpu")
    jn, jdiff = jcompat.compare(img, _pil(other))
    assert type(n) is int and n == jn > 0
    assert diff.mode == "RGBA" and diff.size == img.size
    np.testing.assert_array_equal(np.asarray(diff), np.asarray(jdiff))
    n0, diff0 = tcompat.compare(img, img, tolerance=0, device="cpu")
    assert n0 == 0 and (np.asarray(diff0) == 255).all()


@pytest.mark.parametrize("name", ["gaussian", "sobel"])
def test_gaussian_sobel_vs_jax_facade(page, name):
    img = _pil(page)
    got = getattr(tcompat, name)(img, device="cpu")
    want = getattr(jcompat, name)(img)
    assert got.size == img.size
    assert _lsb(got, want) <= 1


def test_gaussian_arguments_vs_jax_facade(page):
    img = _pil(page)
    got = tcompat.gaussian(img, 1.5, 3, device="cpu")
    assert _lsb(got, jcompat.gaussian(img, 1.5, 3)) <= 1
    assert _lsb(got, tcompat.gaussian(img, device="cpu")) > 0


def test_canny_vs_jax_facade(page):
    img = _pil(page)
    got = np.asarray(tcompat.canny(img, device="cpu"))[..., 0]
    want = np.asarray(jcompat.canny(img))[..., 0]
    edges = int((want > 0).sum())
    assert edges > 0
    assert int((got != want).sum()) <= CANNY_BAR * edges


@pytest.mark.parametrize("mode", [0, 1])
def test_swt_vs_jax_facade(mode):
    img = _pil(text_pages(1, 120, 160)[0])
    got = np.asarray(tcompat.swt(img, mode, device="cpu"))
    want = np.asarray(jcompat.swt(img, mode))
    assert got.shape == want.shape
    a, b = got[..., 0] != 255, want[..., 0] != 255
    iou = (a & b).sum() / max((a | b).sum(), 1)
    assert b.sum() > 300 and iou >= SWT_IOU_BAR, iou


@pytest.mark.parametrize("form", ["gray", "rgb", "rgba"])
def test_numpy_inputs_vs_jax_facade(page, form):
    """Gray, RGB and RGBA numpy in, as the reference's façade takes
    them."""
    arr = {"gray": page[..., 0], "rgb": page[..., :3], "rgba": page}[form]
    for name in ("unpaper_masks", "unpaper_noisefilter"):
        got = getattr(tcompat, name)(arr, device="cpu")
        want = getattr(jcompat, name)(arr)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    n, _ = tcompat.compare(arr, page, device="cpu")
    assert n == jcompat.compare(arr, page)[0]


def test_ace_is_rolled_ops_ace(page):
    """The façade's ace is the port's `ops.ace` in mode "rolled" at the
    default seed, bit for bit."""
    got = np.asarray(tcompat.ace(_pil(page), samples=16, device="cpu"))
    want = tace.ace(torch.from_numpy(page), nb_samples=16,
                    seed=tace.C.ACE_DEFAULT_SEED, mode="rolled").numpy()
    np.testing.assert_array_equal(got, want)
    got7 = np.asarray(tcompat.ace(page, samples=16, seed=7, mode="shared",
                                  device="cpu"))
    want7 = tace.ace(torch.from_numpy(page), nb_samples=16, seed=7,
                     mode="shared").numpy()
    np.testing.assert_array_equal(got7, want7)


def test_signatures_match_jax_facade():
    """The same parameters and defaults as the reference's façade, and a
    keyword-only `device=None` beside them."""
    for name in jcompat.__all__:
        fn = getattr(tcompat, name)
        if not callable(fn) or name == "get_version":
            continue
        params = dict(inspect.signature(fn).parameters)
        dev = params.pop("device")
        assert dev.kind is inspect.Parameter.KEYWORD_ONLY
        assert dev.default is None
        assert list(params.items()) == list(
            inspect.signature(getattr(jcompat, name)).parameters.items()), name


@pytest.mark.parametrize("mode", ["shared", "rolled", "per_pixel"])
def test_ace_statistics_through_facade(page, mode):
    """The reference's statistical checks (tests/test_ace.py) through
    the façade: a constant page maps to 128 +- 1, a page is stretched to
    the full range, the same seed gives the same output."""
    flat = np.full((32, 32, 4), 77, np.uint8)
    flat[..., 3] = 255
    out = np.asarray(tcompat.ace(flat, samples=8, mode=mode, device="cpu"))
    assert out.shape == flat.shape
    assert np.all(np.abs(out[..., :3].astype(int) - 128) <= 1)
    out = np.asarray(tcompat.ace(_pil(page), samples=32, mode=mode,
                                 device="cpu"))
    assert out[..., :3].min() <= 5 and out[..., :3].max() >= 250
    a = tcompat.ace(page, samples=16, seed=7, mode=mode, device="cpu")
    b = tcompat.ace(page, samples=16, seed=7, mode=mode, device="cpu")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shim_surface():
    """`pillowfight_torch` carries the names and values of `pillowfight`
    (tests/test_compat.py)."""
    import pillowfight
    import pillowfight_torch

    assert pillowfight_torch.__all__ == pillowfight.__all__
    for name in (
        "ace", "canny", "compare", "gaussian", "sobel", "swt",
        "unpaper_blackfilter", "unpaper_blurfilter", "unpaper_border",
        "unpaper_grayfilter", "unpaper_masks", "unpaper_noisefilter",
        "get_version",
    ):
        assert callable(getattr(pillowfight_torch, name)), name
        assert getattr(pillowfight_torch, name).__module__.startswith(
            "libpillowfight_tpu_torch"), name
    assert pillowfight_torch.SWT_OUTPUT_BW_TEXT == 0
    assert pillowfight_torch.SWT_OUTPUT_GRAYSCALE_TEXT == 1
    assert pillowfight_torch.SWT_OUTPUT_ORIGINAL_BOXES == 2
    assert pillowfight_torch.get_version() == pillowfight.get_version()


def test_shim_roundtrip(page):
    import pillowfight_torch

    img = _pil(page)
    out = pillowfight_torch.unpaper_border(img, device="cpu")
    assert out.mode == "RGBA" and out.size == img.size
    n, diff = pillowfight_torch.compare(img, img, device="cpu")
    assert n == 0 and diff.size == img.size


def test_no_card_no_device_raises(page, monkeypatch):
    """Without a card and without `device`, a façade call raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.unpaper_border(_pil(page))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcompat.compare(page, page)
