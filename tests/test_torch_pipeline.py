"""The port's run_pipeline vs the JAX run_pipeline: bit-identical for
the unpaper chain, within the ROADMAP parity bars for the gradient
stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from libpillowfight_tpu.core.bitmap import host_pages_to_words
from libpillowfight_tpu.parallel import pipeline as jpipe
import libpillowfight_tpu_torch as pt

# one thread for torch: these planes are small, and beside the other
# workers' XLA compiles a thread pool only waits for its own threads
torch.set_num_threads(1)


def _inputs(name, page):
    if name == "tiny_batch":
        return __graft_entry__._tiny_batch()
    if name == "page_fixture":
        return page
    return __graft_entry__._tiny_batch(b=2, h=256, w=320)


SPECS = {
    "cleanup": jpipe.DOCUMENT_CLEANUP,
    "black_threshold_fallback": (
        ("unpaper_blackfilter", {"black_threshold": 0.5}),
        "unpaper_noisefilter", "unpaper_masks", "unpaper_grayfilter"),
    "kwargs_default_threshold": (
        ("unpaper_blackfilter", {"black_threshold": 0.33, "intensity": 5}),
        ("unpaper_noisefilter", {"intensity": 2}),
        ("unpaper_border", (("scan_threshold", 3),))),
    "noisefilter_k1": (("unpaper_noisefilter", {"intensity": 1}),
                       "unpaper_masks"),
}


@pytest.mark.parametrize("inp", ["tiny_batch", "page_fixture", "256x320"])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("form", ["rgba", "words"])
def test_run_pipeline_bit_identical(page, inp, spec, form):
    pages = _inputs(inp, page)
    jspec = jpipe.normalize_spec(SPECS[spec])
    tspec = pt.normalize_spec(SPECS[spec])
    assert tspec == jspec
    if form == "rgba":
        want = np.asarray(jpipe.run_pipeline(jnp.asarray(pages), jspec))
        got = pt.run_pipeline(torch.from_numpy(pages), tspec)
        assert got.dtype == torch.uint8
        got = got.numpy()
    else:
        words = host_pages_to_words(pages)
        if spec == "black_threshold_fallback":
            # the reference's gray fallback reads RGBA pages only: hold the
            # port's words path to the reference's RGBA result
            want = host_pages_to_words(np.asarray(
                jpipe.run_pipeline(jnp.asarray(pages), jspec)))
        else:
            want = np.asarray(jpipe.run_pipeline(jnp.asarray(words), jspec))
        got = pt.run_pipeline(torch.from_numpy(words.view(np.int32)), tspec)
        assert got.dtype == torch.int32
        got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (want != (pages if form == "rgba"
                     else host_pages_to_words(pages))).any()


GRADIENT_SPECS = {
    "edge_stack": jpipe.EDGE_STACK,
    "cleanup_then_edges": jpipe.DOCUMENT_CLEANUP + jpipe.EDGE_STACK,
    "gaussian_sobel": ("gaussian", "sobel"),
}


@pytest.mark.parametrize("inp", ["tiny_batch", "page_fixture", "256x320"])
@pytest.mark.parametrize("spec", sorted(GRADIENT_SPECS))
@pytest.mark.parametrize("form", ["rgba", "words"])
def test_run_pipeline_gradient_specs(page, inp, spec, form):
    """Bars (ROADMAP): a canny output <= 0.1% of its edge pixels differ,
    gaussian then sobel <= 1 LSB. Measured bit-identical on every case
    here."""
    pages = _inputs(inp, page)
    jspec = jpipe.normalize_spec(GRADIENT_SPECS[spec])
    tspec = pt.normalize_spec(GRADIENT_SPECS[spec])
    assert tspec == jspec
    if form == "rgba":
        want = np.asarray(jpipe.run_pipeline(jnp.asarray(pages), jspec))
        got = pt.run_pipeline(torch.from_numpy(pages), tspec)
        assert got.dtype == torch.uint8
        got = got.numpy()
    else:
        words = host_pages_to_words(pages)
        want = np.asarray(jpipe.run_pipeline(jnp.asarray(words), jspec))
        got = pt.run_pipeline(torch.from_numpy(words.view(np.int32)), tspec)
        assert got.dtype == torch.int32
        want = want.view(np.uint8).reshape(*want.shape, 4)
        got = got.numpy().view(np.uint8).reshape(*got.shape, 4)
    assert got.shape == want.shape == pages.shape
    if spec == "gaussian_sobel":
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    else:
        edges = want[..., 0] > 0
        assert edges.sum() > 20
        assert (got[..., 0] != want[..., 0]).sum() <= 0.001 * edges.sum()
        np.testing.assert_array_equal(got[..., 1], got[..., 0])
        np.testing.assert_array_equal(got[..., 3], 255)


def test_compile_pipeline_and_errors(page):
    fn = pt.compile_pipeline(["unpaper_border", ("unpaper_masks", {})])
    want = np.asarray(jpipe.compile_pipeline(
        ["unpaper_border", ("unpaper_masks", {})])(jnp.asarray(page)))
    np.testing.assert_array_equal(fn(torch.from_numpy(page)).numpy(), want)
    with pytest.raises(ValueError, match="unknown filter"):
        pt.normalize_spec(["unpaper_nope"])
    # every filter name of the JAX package is taken, and none raises
    # NotImplementedError any more
    assert set(jpipe._FILTERS) == set(pt.parallel.pipeline._FILTERS)
    spec = pt.normalize_spec(["unpaper_border", "swt"])
    out = pt.run_pipeline(torch.from_numpy(page), spec)
    assert out.shape == page.shape and out.dtype == torch.uint8
    with pytest.raises(TypeError, match="uint8 RGBA or int32"):
        pt.run_pipeline(torch.from_numpy(page).float(), pt.normalize_spec(
            ["unpaper_border"]))


def test_run_pipeline_swt_equals_op(page):
    """`swt` in a spec equals the op, for RGBA and for words (which it
    takes as they come), and passes its arguments on."""
    tp = torch.from_numpy(page)
    words = tp.view(torch.int32).squeeze(-1)
    spec = pt.normalize_spec([("swt", {})])
    want = pt.swt(tp)
    assert torch.equal(pt.run_pipeline(tp, spec), want)
    got_w = pt.run_pipeline(words, spec)
    assert got_w.dtype == torch.int32
    assert torch.equal(got_w.unsqueeze(-1).view(torch.uint8), want)
    gray = pt.normalize_spec([("swt", {"output_type": 1})])
    assert torch.equal(pt.run_pipeline(tp, gray), pt.swt(tp, 1))


@pytest.mark.parametrize("form", ["rgba", "words"])
def test_run_pipeline_swt_then_cleanup(page, form):
    """swt followed by the cleanup chain runs on either form and equals
    the two steps taken one by one."""
    tp = torch.from_numpy(np.stack([page, page]))
    if form == "words":
        tp = tp.view(torch.int32).squeeze(-1)
    spec = pt.normalize_spec([("swt", {}), *pt.DOCUMENT_CLEANUP])
    out = pt.run_pipeline(tp, spec)
    assert out.shape == tp.shape and out.dtype == tp.dtype
    step = pt.run_pipeline(pt.swt(tp), pt.normalize_spec(pt.DOCUMENT_CLEANUP))
    assert torch.equal(out, step)
