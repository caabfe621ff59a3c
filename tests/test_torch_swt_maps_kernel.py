"""The wrapper of SWT's width-map kernels (`ops/cuda/swt_maps.py`,
`csrc/swt_maps.cu`) on the CPU: it imports without a card, refuses what
the kernels do not take before any launch, reaches its C entry through
`_build.launch` only, and `ops/swt.py` dispatches to it by the tensor's
device alone. The kernels themselves run on the card only: `chip_smoke.py`
holds them bit for bit to the plain passes there.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from libpillowfight_tpu_torch import _build
from libpillowfight_tpu_torch.core.bitmap import pages_to_words, words_to_gray
from libpillowfight_tpu_torch.ops import swt as tswt
from libpillowfight_tpu_torch.ops.canny import (canny_edge_mask_from_gradients,
                                                canny_gradients)
from libpillowfight_tpu_torch.ops.cuda import swt_maps as kswt
from libpillowfight_tpu_torch.utils.pages import text_pages

torch.set_num_threads(1)

MAX_LEN = 128


def _bars_page(h=96, w=128):
    """Dark vertical strokes of width 6 on white (as `test_torch_swt`)."""
    g = np.full((h, w), 255, np.uint8)
    for x0 in (20, 40, 60, 80):
        g[25:75, x0: x0 + 6] = 0
    return g


def _shapes_page(h=96, w=128):
    """U, O and H shapes of 5-px strokes (as `test_torch_swt`)."""
    g = np.full((h, w), 255, np.uint8)
    for x0 in (12, 52, 92):
        g[20:60, x0: x0 + 5] = 0
        g[20:60, x0 + 19: x0 + 24] = 0
    g[55:60, 12:36] = 0
    g[20:25, 52:76] = g[55:60, 52:76] = 0
    g[38:43, 92:116] = 0
    return g


def _inputs(gray8: np.ndarray):
    """(gray, edges, gx, gy) [B,H,W] of uint8 gray pages [B,H,W]."""
    g = torch.from_numpy(gray8)
    rgba = torch.stack([g, g, g, torch.full_like(g, 255)], dim=-1)
    gray = words_to_gray(pages_to_words(rgba))
    gx, gy = canny_gradients(gray)
    return gray, canny_edge_mask_from_gradients(gx, gy), gx, gy


def _plain_maps(edges, gx, gy, max_len):
    """The plain passes strung together as `_swt_maps_one` strings them."""
    edge_cls = tswt._edge_classes(edges, gx, gy)
    chains, swt, a_enc = tswt._width_pass(edge_cls, max_len)
    n_anchors = (((a_enc[-1] | a_enc[1]) >> 16) != 0).sum(
        dim=(-2, -1), dtype=torch.int32)
    med = {s: tswt._ray_medians(swt[s], a_enc[s]) for s in (-1, 1)}
    res = tswt._median_pass(edge_cls, chains, swt, med, max_len)
    return res[-1], res[1], n_anchors


FIXTURES = {
    "bars": lambda: _bars_page()[None],
    "shapes": lambda: _shapes_page()[None],
    "text_pages": lambda: text_pages(2, 120, 100)[..., 0],
}


def test_module_imports_without_a_card():
    assert isinstance(kswt.launches, int)
    assert callable(kswt.swt_maps_cuda)
    assert kswt.use_kernel(torch.zeros(1)) is False
    assert "pft_swt_maps" in _build._SIGNATURES


class _OnCard:
    """Stands for a CUDA tensor in the wrapper's checks, which run before
    anything is allocated or launched."""

    def __init__(self, dtype=torch.bool, shape=(1, 8, 8), contiguous=True,
                 device="cuda"):
        self.device = torch.device(device)
        self.dtype, self.shape, self.ndim = dtype, shape, len(shape)
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


def _angles(**kw):
    return _OnCard(**{"dtype": torch.float32, **kw})


@pytest.mark.parametrize("angles, edges, error, match", [
    (_angles(device="cpu"), _OnCard(), ValueError, "CUDA tensors only"),
    (_angles(), _OnCard(device="cpu"), ValueError, "CUDA tensors only"),
    (_angles(dtype=torch.float64), _OnCard(), TypeError, "dtype"),
    (_angles(), _OnCard(dtype=torch.uint8), TypeError, "dtype"),
    (_angles(), _OnCard(dtype=torch.int8), TypeError, "dtype"),
    (_angles(shape=(8, 8)), _OnCard(shape=(8, 8)), ValueError, "3 dims"),
    (_angles(), _OnCard(shape=(1, 2, 8, 8)), ValueError, "3 dims"),
    (_angles(contiguous=False), _OnCard(), ValueError, "not contiguous"),
    (_angles(), _OnCard(contiguous=False), ValueError, "not contiguous"),
    (_angles(shape=(1, 8, 9)), _OnCard(), ValueError, "vs edges"),
    (_angles(shape=(0, 8, 8)), _OnCard(shape=(0, 8, 8)), ValueError,
     "the kernels take"),
    (_angles(shape=(65536, 8, 8)), _OnCard(shape=(65536, 8, 8)), ValueError,
     "the kernels take"),
    (_angles(shape=(1, 65536, 65536)), _OnCard(shape=(1, 65536, 65536)),
     ValueError, "the kernels take"),
])
def test_wrapper_refuses_before_any_launch(monkeypatch, angles, edges, error,
                                           match):
    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    before = kswt.launches
    with pytest.raises(error, match=match):
        kswt.swt_maps_cuda(angles, edges, *tswt._direction_table(MAX_LEN))
    assert calls == [] and kswt.launches == before


def test_wrapper_refuses_a_short_table(monkeypatch):
    monkeypatch.setattr(_build, "launch", lambda *a: pytest.fail("launched"))
    ints, floats = tswt._direction_table(MAX_LEN)
    with pytest.raises(ValueError, match="direction table"):
        kswt.swt_maps_cuda(_angles(), _OnCard(), ints[:-8], floats)
    with pytest.raises(ValueError, match="direction table"):
        kswt.swt_maps_cuda(_angles(), _OnCard(), ints, floats[:-1])


def test_entry_reached_only_through_build_launch():
    """`pft_swt_maps` is named in the package only as the first argument
    of `_build.launch` in the wrapper, and `_build` declares its C
    signature (pointers, B, H, W, the two host tables, the stream)."""
    where = []
    for path in sorted(_build.CSRC.parent.rglob("*.py")):
        if path.name == "_build.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and node.value == "pft_swt_maps":
                where.append(path.name)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and getattr(node.func.value, "id", "") == "_build"
                    and getattr(node.args[0], "value", "") == "pft_swt_maps"):
                where.append(("launch", path.name))
    assert sorted(where, key=str) == [("launch", "swt_maps.py"), "swt_maps.py"]
    sig = _build._SIGNATURES["pft_swt_maps"]
    assert sig == [_build.P] * 7 + [_build.I] * 3 + [_build.IA, _build.FP,
                                                     _build.P]
    src = (_build.CSRC / "swt_maps.cu").read_text()
    assert 'extern "C" int pft_swt_maps(' in src


@pytest.mark.parametrize("max_len", [1, 7, 128, 1023])
def test_direction_table(max_len):
    """What the kernels read of each class is `_VECS`, `_halves` (far
    first), `_half` (the near cell, which a knight ray also covers),
    `_t_units`, the f32 norms and angles, and pi and 2 pi as f32, which
    `_quantize_angles` compares in; classes 0..7 step down (class 0
    right) and class k + 8 is the opposite of class k, as the kernels
    require."""
    ints, floats = tswt._direction_table(max_len)
    assert len(ints) == 8 * 16 and len(floats) == 4 * 16 + 2
    rows = np.asarray(ints).reshape(16, 8)
    norms = np.asarray(floats[:64], np.float32).reshape(16, 4)
    assert floats[64:] == [float(np.float32(np.pi)),
                           float(np.float32(2 * np.pi))]
    assert floats[64:] == [float(torch.tensor(np.pi, dtype=torch.float32)),
                           float(torch.tensor(2 * np.pi,
                                              dtype=torch.float32))]
    for k, v in enumerate(tswt._VECS):
        dy, dx, knight, fy, fx, ny, nx, t = rows[k]
        assert (dy, dx) == v and t == tswt._t_units(k, max_len)
        halves = tswt._halves(v)
        assert bool(knight) == bool(halves)
        if halves:
            assert ((fy, fx), (ny, nx)) == halves
            assert (ny, nx) == tswt._half(v)
            assert norms[k, 1] == np.float32(np.hypot(fy, fx))
            assert norms[k, 2] == np.float32(np.hypot(ny, nx))
        assert norms[k, 0] == np.float32(tswt._NORMS[k])
        assert norms[k, 3] == tswt._ANGLES.astype(np.float32)[k]
        assert 1 <= t <= 1024
    for k in range(8):
        assert tuple(rows[k + 8, :2]) == tuple(-rows[k, :2])
        assert rows[k + 8, 7] == rows[k, 7]
        assert rows[k, 0] > 0 or tuple(rows[k, :2]) == (0, 1)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cpu_takes_the_plain_passes(monkeypatch, name):
    """On CPU tensors `_swt_maps_one` runs the plain passes, bit for bit
    as they are strung together above, and launches nothing."""
    monkeypatch.setattr(kswt, "swt_maps_cuda",
                        lambda *a: pytest.fail("kernel path on the CPU"))
    before = kswt.launches
    gray, edges, gx, gy = _inputs(FIXTURES[name]())
    got = tswt._swt_maps_one(gray, edges, gx, gy, MAX_LEN)
    want = _plain_maps(edges, gx, gy, MAX_LEN)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(want[2].sum()) > 0 and bool((want[0] < tswt._INF).any())
    assert kswt.launches == before
    # one page [H,W] in: the same maps, unbatched
    one = tswt._swt_maps_one(gray[0], edges[0], gx[0], gy[0], MAX_LEN)
    for g, w in zip(one, got):
        assert torch.equal(g, w[0])


def _fake_kernel(calls):
    """A stand-in for `swt_maps_cuda` that records its calls and returns
    the plain passes' maps of its angles and edges."""
    def kernel(angles, edges, ints, floats):
        assert angles.dtype == torch.float32 and angles.ndim == 3
        assert edges.dtype == torch.bool and edges.shape == angles.shape
        assert edges.is_contiguous() and angles.is_contiguous()
        assert (ints, floats) == tswt._direction_table(MAX_LEN)
        calls.append(tuple(edges.shape))
        return tswt._width_maps_plain(torch.where(
            edges, tswt._quantize_angles(angles), -1).to(torch.int8), MAX_LEN)
    return kernel


def test_kernel_path_dispatch_and_chunks(monkeypatch):
    """Where the dispatch answers "kernel", `swt_maps` hands the kernel
    whole batches up to `_KERNEL_MAPS_CHUNK_PIXELS` (the plain path's
    `_MAPS_CHUNK_PIXELS` chunks are not taken), `_swt_maps_one` batches a
    single page for it and unbatches the result, and the maps and
    anchors are those of the plain path: the edge classes the kernel
    makes of `_gradient_angles` are `_edge_classes`."""
    gray, edges, gx, gy = _inputs(text_pages(5, 40, 30)[..., 0])
    want = tswt.swt_maps(edges, gx, gy, MAX_LEN)
    calls = []
    monkeypatch.setattr(kswt, "use_kernel", lambda *t: True)
    monkeypatch.setattr(kswt, "swt_maps_cuda", _fake_kernel(calls))
    monkeypatch.setattr(tswt, "_MAPS_CHUNK_PIXELS", 40 * 30)
    got = tswt.swt_maps(edges, gx, gy, MAX_LEN)
    assert calls == [(5, 40, 30)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    monkeypatch.setattr(tswt, "_KERNEL_MAPS_CHUNK_PIXELS", 2 * 40 * 30)
    calls.clear()
    got = tswt.swt_maps(edges, gx, gy, MAX_LEN)
    assert calls == [(2, 40, 30), (2, 40, 30), (1, 40, 30)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    calls.clear()
    one = tswt._swt_maps_one(gray[3], edges[3], gx[3], gy[3], MAX_LEN)
    assert calls == [(1, 40, 30)]
    calls.clear()
    rows = tswt._swt_maps_one(None, edges[:, 5:35], gx[:, 5:35], gy[:, 5:35],
                              MAX_LEN)  # row slabs: not contiguous
    assert calls == [(5, 30, 30)]
    plain = tswt._width_maps_plain(tswt._edge_classes(
        edges[:, 5:35], gx[:, 5:35], gy[:, 5:35]), MAX_LEN)
    for g, w in zip(rows, plain):
        assert torch.equal(g, w)
    assert [tuple(x.shape) for x in one] == [(40, 30), (40, 30), ()]
    for g, w in zip(one, want):
        assert torch.equal(g, w[3])


def test_edge_classes_from_angles():
    """`_edge_classes` is the quantization of `_gradient_angles` at the
    edges, the split the kernel path takes (the angles from torch, the
    rest in the kernel); `_quantize_dirs` is the quantization of atan2."""
    _, edges, gx, gy = _inputs(text_pages(2, 64, 48)[..., 0])
    ang = tswt._gradient_angles(gx, gy)
    assert torch.equal(tswt._edge_classes(edges, gx, gy), torch.where(
        edges, tswt._quantize_angles(ang), -1).to(torch.int8))
    norm = torch.sqrt(gx * gx + gy * gy).clamp(min=1e-6)
    assert torch.equal(tswt._quantize_dirs(gx / norm, gy / norm),
                       tswt._quantize_angles(ang))


def test_plain_chunks_unchanged_on_the_cpu(monkeypatch):
    """On the CPU `swt_maps` still goes `_MAPS_CHUNK_PIXELS` at a time,
    and the chunks join into the whole batch's maps."""
    _, edges, gx, gy = _inputs(text_pages(3, 40, 30)[..., 0])
    whole = tswt.swt_maps(edges, gx, gy, MAX_LEN)
    seen = []
    one = tswt._swt_maps_one
    monkeypatch.setattr(tswt, "_swt_maps_one",
                        lambda g, e, *a: seen.append(e.shape[0]) or one(
                            g, e, *a))
    monkeypatch.setattr(tswt, "_MAPS_CHUNK_PIXELS", 2 * 40 * 30)
    parts = tswt.swt_maps(edges, gx, gy, MAX_LEN)
    assert seen == [2, 1]
    for g, w in zip(parts, whole):
        assert torch.equal(g, w)


def test_source_note_and_counter():
    """The source says what it replaces (nothing) and what bounds it,
    as every kernel source of the port does."""
    src = (_build.CSRC / "swt_maps.cu").read_text()
    head = src.split("#include")[0]
    assert "Replaces no TPU kernel" in head
    assert "What bounds it" in head
    py = Path(kswt.__file__).read_text()
    assert "launches += 1" in py
