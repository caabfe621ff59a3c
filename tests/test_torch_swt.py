"""The port's SWT vs the JAX package on the CPU, piece by piece on
injected inputs (made from a seed with numpy) and end to end.

Tolerances: the chain state, the decoded chains, the width maps, the gray
median and the letter pass on the reference's own maps are bit-identical;
direction classes are equal but within 1e-4 rad of a class boundary
(atan2 differs in the last place between the two libraries); the letter
mask end to end is held to IoU >= 0.99 and box pixels to <= 2% strays
(ROADMAP's SWT bar). Every JAX function is compiled once, in a
module-scoped fixture.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.core import bitmap as jbitmap
from libpillowfight_tpu.core import constants as JC
from libpillowfight_tpu.ops.canny import (canny_edge_mask_from_gradients,
                                          canny_gradients)
from libpillowfight_tpu_torch.core import constants as TC
from libpillowfight_tpu_torch.ops import swt as tswt

# one thread for torch: these planes are small, and beside the other
# workers' XLA compiles a thread pool only waits for its own threads
torch.set_num_threads(1)

# `libpillowfight_tpu.ops.swt` the attribute is the function (re-exported
# by the package), so the module is fetched by name
jswt = importlib.import_module("libpillowfight_tpu.ops.swt")

H, W = 96, 128
MAX_LEN = JC.SWT_MAX_RAY_LEN
MAX_LETTERS, MAX_RUNS = 1024, 1024


def _rgba(gray2d):
    g = np.asarray(gray2d, np.uint8)
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


def _text_page(h=H, w=W):
    """Dark bar-'letters' of consistent stroke width on white."""
    g = np.full((h, w), 255, np.uint8)
    for x0 in (20, 40, 60, 80):
        g[25:75, x0: x0 + 6] = 0  # vertical strokes, width 6, height 50
    return g


def _shapes_page(h=H, w=W):
    """U, O and H shapes of 5-px strokes: components with two runs in
    one row, separated by background."""
    g = np.full((h, w), 255, np.uint8)
    for x0 in (12, 52, 92):
        g[20:60, x0: x0 + 5] = 0
        g[20:60, x0 + 19: x0 + 24] = 0
    g[55:60, 12:36] = 0                      # U: a foot
    g[20:25, 52:76] = g[55:60, 52:76] = 0    # O: top and foot
    g[38:43, 92:116] = 0                     # H: a bar
    return g


def _t(x):
    return torch.from_numpy(np.array(x))


class _Ref:
    """The JAX package's intermediate results on one page."""

    def __init__(self, gray8):
        self.page = _rgba(gray8)
        words = jbitmap.pages_to_words(jnp.asarray(self.page)[None])
        self.gray = np.asarray(_jgray(words))
        gx, gy = _jgrads(self.gray)
        self.gx, self.gy = np.asarray(gx), np.asarray(gy)
        self.edges = np.asarray(_jedges(self.gx, self.gy))
        sm, sp, na = _jmaps(self.gray[0], self.edges[0], self.gx[0],
                            self.gy[0])
        self.minus, self.plus = np.asarray(sm), np.asarray(sp)
        self.n_anchors = int(na)
        self.med = np.asarray(_jmed(self.gray))
        self.letters = [np.asarray(x) for x in _jletters(
            self.gray[0], self.minus, self.plus, self.med[0])]


_jgray = jax.jit(jbitmap.words_to_gray)
_jgrads = jax.jit(canny_gradients)
_jedges = jax.jit(canny_edge_mask_from_gradients)
_jmaps = jax.jit(functools.partial(jswt._swt_maps_one, max_len=MAX_LEN))
_jmed = jax.jit(jswt._median_gray)
_jletters = jax.jit(functools.partial(
    jswt._letter_mask_one, max_letters=MAX_LETTERS, max_runs=MAX_RUNS))


@pytest.fixture(scope="module")
def ref_text():
    return _Ref(_text_page())


@pytest.fixture(scope="module")
def ref_shapes():
    return _Ref(_shapes_page())


@pytest.fixture(scope="module")
def ours_mode0():
    """The port's mode 0 on the text page, with its debug counts."""
    return tswt.swt(_t(_rgba(_text_page())), return_debug=True)


def test_constants_and_vectors_match():
    assert tswt._VECS == jswt._VECS and tswt._CHAIN_MISS == jswt._CHAIN_MISS
    assert tswt._MED_SAMPLES == jswt._MED_SAMPLES
    for v in jswt._VECS:
        assert tswt._half(v) == jswt._half(v)
        assert tswt._halves(v) == jswt._halves(v)
    for name in dir(JC):
        if name.startswith("SWT_"):
            assert getattr(TC, name) == getattr(JC, name), name


def test_quantize_dirs_matches(rng):
    """Equal classes but within 1e-4 rad of a boundary between two
    classes."""
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, 4000),
                          jswt._ANGLES, [np.pi, -np.pi]])
    ux, uy = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want = np.asarray(jswt._quantize_dirs(jnp.asarray(ux), jnp.asarray(uy)))
    got = tswt._quantize_dirs(_t(ux), _t(uy))
    assert got.dtype == torch.int8
    got = got.numpy()
    srt = np.sort(jswt._ANGLES)
    bounds = np.concatenate([(srt[1:] + srt[:-1]) / 2,
                             [(srt[0] + 2 * np.pi + srt[-1]) / 2]])
    dist = np.abs((ang[:, None] - bounds[None] + np.pi) % (2 * np.pi)
                  - np.pi).min(axis=1)
    assert ((got == want) | (dist < 1e-4)).all()
    assert (got == want).mean() > 0.999
    assert len(set(got.tolist())) == 16


@pytest.mark.parametrize("with_payloads", [False, True])
@pytest.mark.parametrize("k", [0, 2, 1, 13], ids=["axis", "diagonal",
                                                  "knight", "knight_up"])
def test_first_edge_chain_bit_identical(rng, k, with_payloads):
    """The packed chain state, its decode and the pulled payloads on
    random edge classes (6% edges)."""
    edge_cls = np.where(rng.random((64, 80)) < 0.06,
                        rng.integers(0, 16, (64, 80)), -1).astype(np.int8)
    pls = ([rng.random((64, 80)).astype(np.float32) for _ in range(2)]
           if with_payloads else [])
    want = jswt._first_edge_along(jnp.asarray(edge_cls), k, 16,
                                  tuple(jnp.asarray(p) for p in pls))
    got = tswt._first_edge_along(_t(edge_cls), k, 16,
                                 tuple(_t(p) for p in pls))
    assert len(got) == len(want) == 1 + len(pls)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    # decoded under jit, as the reference's swt runs it (compiled, the
    # knight distance is one fused multiply-add)
    jdecode = jax.jit(functools.partial(jswt._decode_chain, k=k))
    for g, w_ in zip(tswt._decode_chain(got[0], k), jdecode(want[0])):
        g, w_ = g.numpy(), np.asarray(w_)
        if g.dtype == np.int32 and (w_ == -1).any():  # class: -1 on a miss
            np.testing.assert_array_equal(g, w_)
        elif g.dtype == np.int32:                      # units: hits only
            hit = (np.asarray(want[0]) >> 11) & 31
            np.testing.assert_array_equal(g[hit < 16], w_[hit < 16])
        else:
            np.testing.assert_array_equal(g, w_)
    assert (got[0].numpy() != tswt._CHAIN_MISS).any()


def test_swt_maps_bit_identical(ref_text):
    """Both width maps on the reference's own gray, edges and gradients:
    equal bits where finite, _INF in the same places, equal anchors."""
    minus, plus, n_anchors = tswt._swt_maps_one(
        _t(ref_text.gray[0]), _t(ref_text.edges[0]), _t(ref_text.gx[0]),
        _t(ref_text.gy[0]), MAX_LEN)
    for got, want in ((minus, ref_text.minus), (plus, ref_text.plus)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(n_anchors) == ref_text.n_anchors > 0
    assert (ref_text.minus < 1e9).sum() > 500


def test_swt_maps_batched_equals_per_page(ref_text, ref_shapes):
    """A batch of two pages gives each page's own maps."""
    refs = (ref_text, ref_shapes)
    stack = [_t(np.stack([getattr(r, name)[0] for r in refs]))
             for name in ("gray", "edges", "gx", "gy")]
    minus, plus, n_anchors = tswt._swt_maps_one(*stack, MAX_LEN)
    for i, r in enumerate(refs):
        np.testing.assert_array_equal(minus[i].numpy(), r.minus)
        np.testing.assert_array_equal(plus[i].numpy(), r.plus)
        assert int(n_anchors[i]) == r.n_anchors


def test_median_gray_bit_identical(rng, ref_text):
    np.testing.assert_array_equal(
        tswt._median_gray(_t(ref_text.gray)).numpy(), ref_text.med)
    for shape in ((2, 31, 33), (2, 30, 33)):  # odd and even pixel counts
        s3 = rng.integers(0, 766, shape).astype(np.uint32)
        r, g, b = s3 // 3 + (s3 % 3 > 0), s3 // 3 + (s3 % 3 > 1), s3 // 3
        gray = np.asarray(_jgray(jnp.asarray(r | g << 8 | b << 16)))
        np.testing.assert_array_equal(
            tswt._median_gray(_t(gray)).numpy(),
            np.asarray(jswt._median_gray(jnp.asarray(gray))))


def _assert_letters_equal(ref):
    mask, boxes, ok, n_runs, n_letters = tswt._letter_mask_one(
        _t(ref.gray[0]), _t(ref.minus), _t(ref.plus), _t(ref.med)[0],
        MAX_LETTERS, MAX_RUNS)
    jmask, jboxes, jok, jruns, jletters = ref.letters
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert ({tuple(b) for b in boxes.numpy()[ok.numpy()].tolist()}
            == {tuple(b) for b in jboxes[jok].tolist()})
    assert int(n_runs) == int(jruns) and int(n_letters) == int(jletters)
    return mask.numpy(), int(n_runs), int(n_letters)


def test_letter_mask_equal_on_reference_maps(ref_text):
    """Mask, accepted boxes (as a set), run and letter counts, on the
    reference's own width maps."""
    mask, n_runs, n_letters = _assert_letters_equal(ref_text)
    assert n_letters >= 4 and mask.sum() > 500 and n_runs >= 4 * 40


def test_row_runs_do_not_bridge_gaps(ref_shapes):
    """Components with two runs in one row (U, O, H): the two runs stay
    two runs, and the component's count, sums and box still come out as
    the reference's row-run chains give them."""
    mask, n_runs, n_letters = _assert_letters_equal(ref_shapes)
    assert n_letters >= 3
    assert mask[30, 14] and mask[30, 33] and not mask[30, 24]


def test_letter_run_cap_equals_reference(ref_text):
    """A max_runs below the page's runs drops the runs past the cap from
    the statistics, as the reference's truncated run list does. (The
    reference needs max_letters <= max_runs: its nesting test slices the
    run list to max_letters.)"""
    cap = 100
    want = [np.asarray(x) for x in jswt._letter_mask_one(
        jnp.asarray(ref_text.gray[0]), jnp.asarray(ref_text.minus),
        jnp.asarray(ref_text.plus), jnp.asarray(ref_text.med[0]), cap, cap)]
    got = tswt._letter_mask_one(
        _t(ref_text.gray[0]), _t(ref_text.minus), _t(ref_text.plus),
        _t(ref_text.med)[0], cap, cap)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert int(got[3]) == int(want[3]) > cap


def test_swt_mode0_end_to_end(ours_mode0):
    """The whole op against the JAX op: letter-mask IoU >= 0.99."""
    page = _rgba(_text_page())
    want, jdbg = jswt.swt(jnp.asarray(page), return_debug=True)
    want = np.asarray(want)
    got, dbg = ours_mode0
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    a, b = got[..., 0] == 0, want[..., 0] == 0
    iou = (a & b).sum() / max((a | b).sum(), 1)
    assert iou >= 0.99, f"letter-mask IoU {iou:.4f} (bar 0.99)"
    assert b.sum() > 500
    np.testing.assert_array_equal(got[..., 3], page[..., 3])
    for key in ("n_anchors", "n_runs", "n_letters"):
        assert int(dbg[key].max()) == int(np.asarray(jdbg[key]).max()), key
    assert dbg["max_runs"] == jdbg["max_runs"]
    assert dbg["max_letters"] == jdbg["max_letters"]


def test_swt_grayscale_mode_from_mode0_mask(ours_mode0):
    """Mode 1 keeps the page's gray on the letters mode 0 found and is
    white elsewhere."""
    page = _rgba(_text_page())
    page[30:40, 22:24, :3] = 40  # a lighter patch inside a stroke
    letters0 = tswt.swt(_t(page))[..., 0].numpy() == 0
    out = tswt.swt(_t(page), TC.SWT_OUTPUT_GRAYSCALE_TEXT).numpy()
    np.testing.assert_array_equal(
        out[..., 0], np.where(letters0, page[..., 0], 255))
    np.testing.assert_array_equal(out[..., 0], out[..., 2])
    assert (out[..., 3] == 255).all() and letters0.sum() > 500
    assert ours_mode0[0].shape == out.shape


def _perimeters(boxes, ok, h, w):
    on = np.zeros((h, w), bool)
    for (y0, y1, x0, x1), good in zip(boxes.tolist(), ok.tolist()):
        if good:
            on[[y0, y1], x0:x1 + 1] = True
            on[y0:y1 + 1, [x0, x1]] = True
    return on


def test_swt_boxes_mode(ref_text):
    """Mode 2: red exactly on the perimeters of the boxes the letter pass
    accepts, the page elsewhere; against the reference's boxes no more
    than 2% of box pixels stray."""
    page = _rgba(_text_page())
    out = tswt.swt(_t(page), TC.SWT_OUTPUT_ORIGINAL_BOXES).numpy()
    red = (out[..., 0] == 255) & (out[..., 1] == 0) & (out[..., 2] == 0)
    np.testing.assert_array_equal(out[~red], page[~red])
    assert (out[..., 3] == 255).all()
    want = _perimeters(ref_text.letters[1], ref_text.letters[2], H, W)
    strays = (red ^ want).sum() / max(want.sum(), 1)
    assert want.sum() > 0 and strays <= 0.02, f"box strays {strays:.4f}"


def test_swt_boxes_mode_vs_reference():
    """Mode 2 end to end against the JAX op: box strays <= 2%."""
    page = _rgba(_text_page())
    want = np.asarray(jswt.swt(jnp.asarray(page),
                               JC.SWT_OUTPUT_ORIGINAL_BOXES))
    got = tswt.swt(_t(page), TC.SWT_OUTPUT_ORIGINAL_BOXES).numpy()
    a = (got[..., 0] == 255) & (got[..., 1] == 0)
    b = (want[..., 0] == 255) & (want[..., 1] == 0)
    strays = (a ^ b).sum() / max(b.sum(), 1)
    assert b.sum() > 0 and strays <= 0.02, f"box strays {strays:.4f}"
    np.testing.assert_array_equal(got[~a], want[~a])


def test_boxes_on_mask_equals_drawn_perimeters(rng):
    boxes = np.zeros((2, 6, 4), np.int32)
    for b in range(2):
        for i in range(6):
            y0, x0 = rng.integers(0, 30), rng.integers(0, 40)
            boxes[b, i] = (y0, y0 + rng.integers(0, 10), x0,
                           x0 + rng.integers(0, 10))
    boxes[0, 0] = (0, 39, 0, 49)  # the whole page
    ok = rng.random((2, 6)) < 0.7
    ok[0, 0] = True
    got = tswt._boxes_on_mask(_t(boxes), _t(ok), 40, 50).numpy()
    want = np.asarray(jswt._boxes_on_mask(jnp.asarray(boxes),
                                          jnp.asarray(ok), 40, 50))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], _perimeters(boxes[1], ok[1], 40, 50))


def test_swt_max_len_guard_and_bad_mode():
    page = _t(_rgba(_text_page()))
    with pytest.raises(ValueError, match="max_len"):
        tswt.swt(page, max_len=1024)
    with pytest.raises(ValueError, match="output_type"):
        tswt.swt(page, output_type=3)
    with pytest.raises(TypeError, match="uint8 RGBA or int32"):
        tswt.swt(page.to(torch.float32))


def test_swt_blank_page_no_text():
    out, dbg = tswt.swt(_t(_rgba(np.full((64, 64), 255))), return_debug=True)
    assert (out[..., 0] == 255).all() and int(dbg["n_letters"].sum()) == 0


def test_swt_words_in_words_out(ours_mode0):
    """int32 words [B,H,W] in, words out, the same bytes as RGBA gives;
    dead parameters are accepted; one page or a batch."""
    page = _t(_rgba(_text_page()))
    words = page.view(torch.int32).squeeze(-1)
    out = tswt.swt(torch.stack([words, words]), max_rays=5, max_edges=7)
    assert out.dtype == torch.int32 and out.shape == (2, H, W)
    for i in range(2):
        assert torch.equal(out[i].unsqueeze(-1).view(torch.uint8),
                           ours_mode0[0])
    assert torch.equal(tswt.swt(words), out[0])
