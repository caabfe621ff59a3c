"""The port's top-level names against the reference package's: every
name of `libpillowfight_tpu.__all__` (the `compat` façade and `io`
included), the 15 names of `ops`, the version, and the six `unpaper_*`
functions as the top level exports them, bit-identical to the
reference's on a small CPU page."""

import numpy as np
import pytest
import torch

import bench
import libpillowfight_tpu as pf
import libpillowfight_tpu_torch as pt

torch.set_num_threads(1)

UNPAPER = ("unpaper_blackfilter", "unpaper_noisefilter", "unpaper_blurfilter",
           "unpaper_masks", "unpaper_grayfilter", "unpaper_border")


def test_top_level_names():
    missing = [n for n in pf.__all__ if not hasattr(pt, n)]
    assert missing == []
    assert set(pf.__all__) <= set(pt.__all__)
    for sub in ("compat", "core", "io", "ops", "parallel"):
        assert getattr(pt, sub).__name__ == f"libpillowfight_tpu_torch.{sub}"
    assert (pt.SWT_OUTPUT_BW_TEXT, pt.SWT_OUTPUT_GRAYSCALE_TEXT,
            pt.SWT_OUTPUT_ORIGINAL_BOXES) == (pf.SWT_OUTPUT_BW_TEXT,
                                              pf.SWT_OUTPUT_GRAYSCALE_TEXT,
                                              pf.SWT_OUTPUT_ORIGINAL_BOXES)


def test_ops_names():
    assert pt.ops.__all__ == pf.ops.__all__
    for name in pt.ops.__all__:
        assert callable(getattr(pt.ops, name))
        assert getattr(pt.ops, name).__module__.startswith(
            "libpillowfight_tpu_torch.ops")


def test_version():
    assert pt.__version__ == pf.__version__
    assert pt.get_version() == pf.get_version()


@pytest.fixture(scope="module")
def small_page():
    pages = bench._pages(1, 130, 170, seed=4)
    pages[0, 60:64, 20:120, :3] = 10   # a bar attached to the border
    pages[0, 90:94, 140:144, :3] = 120  # a lonely smudge
    return pages


@pytest.mark.parametrize("name", UNPAPER)
def test_unpaper_top_level_vs_reference(small_page, name):
    got = getattr(pt, name)(torch.from_numpy(small_page)).numpy()
    want = np.asarray(getattr(pf, name)(small_page))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
