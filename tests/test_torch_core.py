"""Port core vs the JAX reference: constants, import hygiene, word
views, block statistics, and the device dispatch of the kernel wrappers."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpillowfight_tpu.core import bitmap as jbm
from libpillowfight_tpu.core import constants as JC
from libpillowfight_tpu.ops.unpaper import common as jcommon
from libpillowfight_tpu_torch.core import bitmap as tbm
from libpillowfight_tpu_torch.core import constants as TC
from libpillowfight_tpu_torch.ops.cuda import (ace as tace,
                                               flood_packed as tflood,
                                               flood_sweep as tsweep,
                                               gaussian as tgauss,
                                               label as tlabel,
                                               linecount as tlc, noise as tnoise)
from libpillowfight_tpu_torch.ops.unpaper import common as tcommon


def test_constants_match_reference():
    names = [n for n in vars(TC) if n.isupper()]
    assert len(names) >= 20
    for n in names:
        assert getattr(TC, n) == getattr(JC, n), n


def test_import_leaves_jax_out():
    code = ("import sys, libpillowfight_tpu_torch, "
            "libpillowfight_tpu_torch.ops.morph, "
            "libpillowfight_tpu_torch.ops.unpaper, "
            "libpillowfight_tpu_torch.ops.gaussian, "
            "libpillowfight_tpu_torch.ops.sobel, "
            "libpillowfight_tpu_torch.ops.canny, "
            "libpillowfight_tpu_torch.ops.ace, "
            "libpillowfight_tpu_torch.ops.swt, "
            "libpillowfight_tpu_torch.utils.pages, "
            "libpillowfight_tpu_torch._build; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'libpillowfight_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _rgba(rng, b=2, h=37, w=53):
    return rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)  # alpha >= 128 too


def test_word_views_and_gray(rng):
    pages = _rgba(rng)
    words_np = jbm.host_pages_to_words(pages)
    tp = torch.from_numpy(pages)
    tw = tbm.pages_to_words(tp)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), words_np)
    np.testing.assert_array_equal(tbm.words_to_pages(tw).numpy(), pages)
    jw = jnp.asarray(words_np)
    # jitted, as run_pipeline runs it (XLA computes x/3.0 as x*f32(1/3))
    np.testing.assert_array_equal(tbm.words_to_gray(tw).numpy(),
                                  np.asarray(jax.jit(jbm.words_to_gray)(jw)))
    np.testing.assert_array_equal(tbm.rgba_to_gray(tp).numpy(),
                                  np.asarray(jbm.rgba_to_gray(jnp.asarray(pages))))
    np.testing.assert_array_equal(tbm.words_to_s3(tw).numpy(),
                                  np.asarray(jbm.words_to_s3(jw)).astype(np.int32))
    wipe = rng.random(words_np.shape) < 0.5
    got = tbm.wipe_white_words(tw, torch.from_numpy(wipe)).numpy()
    np.testing.assert_array_equal(
        got.view(np.uint32),
        np.asarray(jbm.wipe_white_words(jw, jnp.asarray(wipe))))


def test_ensure_batched_forms():
    for shape, unb in [((5, 6), True), ((5, 6, 4), True), ((2, 5, 6), False),
                       ((2, 5, 6, 4), False)]:
        x, u = tbm.ensure_batched(torch.zeros(shape))
        assert u == unb and tbm.maybe_unbatch(x, u).shape == shape
    with pytest.raises(ValueError):
        tbm.ensure_batched(torch.zeros(3))


def test_dark_and_nonwhite_masks(rng):
    # every reachable gray value k/3, around both thresholds
    s3 = np.arange(766, dtype=np.int32).reshape(1, 2, 383)
    gray = torch.from_numpy(s3).to(torch.float32) / 3.0
    jg = jnp.asarray(gray.numpy())
    np.testing.assert_array_equal(tcommon.dark_mask(gray).numpy(),
                                  np.asarray(jcommon.dark_mask(jg)))
    np.testing.assert_array_equal(tcommon.dark_mask(gray, 0.5).numpy(),
                                  np.asarray(jcommon.dark_mask(jg, 0.5)))
    np.testing.assert_array_equal(tcommon.nonwhite_mask(gray).numpy(),
                                  np.asarray(jcommon.nonwhite_mask(jg)))


@pytest.mark.parametrize("size,step", [(20, 5), (100, 50), (50, 20), (7, 3),
                                       (5, 5), (3, 4)])
def test_block_stats_and_coverage(rng, size, step):
    h, w = 263, 347  # multiples of no step
    x = rng.random((2, h, w)) < 0.3
    s3 = rng.integers(0, 766, (2, h, w)).astype(np.uint16)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    got = tcommon.block_counts(tx, size, step)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcommon.block_counts(jx, size, step)))
    if size * 765 < 65536:  # the reference's domain
        np.testing.assert_array_equal(
            tcommon.block_sums_u16(torch.from_numpy(s3.astype(np.int32)),
                                   size, step).numpy(),
            np.asarray(jcommon.block_sums_u16(jnp.asarray(s3), size, step)))
    sel = got.numpy() > np.median(got.numpy())
    np.testing.assert_array_equal(
        tcommon.coverage_from_blocks(torch.from_numpy(sel), (2, h, w), size,
                                     step).numpy(),
        np.asarray(jcommon.coverage_from_blocks(jnp.asarray(sel), (2, h, w),
                                                size, step)))


def test_block_stats_domain_errors():
    x = torch.zeros((1, 300, 300), dtype=torch.bool)
    with pytest.raises(ValueError, match="size=257"):
        tcommon.block_counts(x, 257, 1)
    with pytest.raises(ValueError, match="size=200"):
        tcommon.block_counts(torch.zeros((1, 3000, 300), dtype=torch.bool),
                             200, 2)
    with pytest.raises(ValueError, match="size=86"):
        tcommon.block_sums_u16(x.to(torch.int32), 86, 10)


def test_cuda_path_never_takes_cpu_tensors():
    """A kernel wrapper refuses a tensor off the card, and the
    dispatchers refuse any device other than cpu and cuda: nothing
    that was meant for the card runs silently on the CPU."""
    plane = torch.zeros((1, 40, 33), dtype=torch.bool)
    words = torch.zeros((1, 2, 33), dtype=torch.int32)
    for call in (lambda: tlc.line_counts_cuda(plane),
                 lambda: tflood.pack_rows_cuda(plane),
                 lambda: tflood.unpack_rows_cuda(words, 40),
                 lambda: tflood.flood_packed_cuda(words, words.clone(), 40,
                                                  33),
                 lambda: tnoise.noise_cert_cuda(plane, 2, 5),
                 lambda: tnoise.noise_ball_cuda(plane, 1),
                 lambda: tgauss.gaussian_sep_cuda(plane.float(), (1.0,)),
                 lambda: tlabel.label_links_cuda(plane, None),
                 lambda: tsweep.flood_sweep_cuda(plane, plane),
                 lambda: tace.ace_spray_cuda(
                     plane.float()[None].expand(1, 3, 40, 33), words[0],
                     words[0], words[0].float()[None], 10.0, 1000.0)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    meta = plane.to("meta")
    for call in (lambda: tlc.line_counts(meta),
                 lambda: tflood.pack_rows(meta),
                 lambda: tnoise.noise_cert(meta, 2, 5),
                 lambda: tnoise.noise_ball(meta, 1),
                 lambda: tgauss.gaussian_sep(meta.float(), (1.0,)),
                 lambda: tlabel.label_links(meta, {(0, 1): meta}),
                 lambda: tsweep.flood_sweep(meta, meta),
                 lambda: tflood.flood_packed(words.to("meta"),
                                             words.to("meta"), 40, 33)):
        with pytest.raises(ValueError, match="device meta"):
            call()
    with pytest.raises(ValueError, match="tensors on"):
        tflood.flood_packed(words, words.to("meta"), 40, 33)


def test_c_entries_match_their_ctypes_signatures():
    """Every `extern "C"` entry of csrc/ is bound with the argument types
    of its C declaration, and nothing else is bound: a mismatch would
    otherwise show only when the library is loaded on a card."""
    import re

    from libpillowfight_tpu_torch import _build

    ctype = {"void*": _build.P, "int": _build.I, "float": _build.F,
             "float*": _build.FP, "int*": _build.IP}
    declared = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            types = []
            for param in params.split(","):
                *ty, var = param.replace("const", "").split()
                types.append(ctype["".join(ty) + "*" * var.count("*")])
            declared[name] = types
    assert declared == _build._SIGNATURES


def test_every_kernel_launch_goes_through_the_device_guard(monkeypatch):
    """No module of the port names a C entry but `_build`: each wrapper
    hands the entry's name to `_build.launch` (the kernels) or
    `_build.host_size` (the two host-side sizes), and every entry is
    reached that way. `launch` calls the entry inside
    `torch.cuda.device(t.device)` and raises on its error code."""
    import ast
    import contextlib
    import types

    from libpillowfight_tpu_torch import _build

    named, passed, seen = [], set(), set()
    for path in sorted(_build.CSRC.parent.rglob("*.py")):
        if path.name == "_build.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert not node.attr.startswith("pft_"), (path, node.attr)
            if isinstance(node, ast.Constant) and \
                    node.value in _build._SIGNATURES:
                named.append(node)  # keeps the node, and so its id, alive
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("launch", "host_size")
                    and getattr(node.func.value, "id", "") == "_build"):
                passed.add(id(node.args[0]))
                seen.add((node.func.attr, node.args[0].value))
    assert named and all(id(n) in passed for n in named)
    sizes = {"pft_flood_packed_smem", "pft_label_scratch_bytes"}
    assert seen == {("host_size" if n in sizes else "launch", n)
                    for n in _build._SIGNATURES}

    current = [torch.device("cuda", 0)]

    @contextlib.contextmanager
    def device(dev):
        current.append(torch.device(dev))
        try:
            yield
        finally:
            current.pop()

    calls = []
    lib = types.SimpleNamespace(
        pft_line_counts=lambda *a: calls.append((current[-1], a)) or 0,
        pft_pack_rows=lambda *a: 700)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "device", device)
    t = types.SimpleNamespace(device=torch.device("cuda", 1))
    _build.launch("pft_line_counts", t, 11, 12)
    assert calls == [(torch.device("cuda", 1), (11, 12, 7))]
    assert current == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="pft_pack_rows: CUDA error 700"):
        _build.launch("pft_pack_rows", t)
    assert current == [torch.device("cuda", 0)]


def test_synthetic_pages_equal_bench_pages():
    """The port's page generator is byte-identical to the one the JAX
    package's bench.py times, for the same arguments."""
    import bench
    from libpillowfight_tpu_torch.utils.pages import (synthetic_pages,
                                                      text_pages)

    for seed in (0, 3):
        np.testing.assert_array_equal(synthetic_pages(2, 64, 80, seed),
                                      bench._pages(2, 64, 80, seed))
    np.testing.assert_array_equal(synthetic_pages(1, 300, 260),
                                  bench._pages(1, 300, 260))
    glyphs = text_pages(1, 600, 500)
    assert glyphs.shape == (1, 600, 500, 4) and glyphs.dtype == np.uint8
    assert (glyphs != synthetic_pages(1, 600, 500)).any()
