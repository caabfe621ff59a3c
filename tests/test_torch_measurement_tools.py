"""The port's measurement tools on the CPU: `bench_torch.py` (its timing
function against the JAX `run_pipeline`, its refusal without a card, its
record, its check, the temporary directory it leaves as it found it) and
the six `tools/profile_*.py` (their stage labels, "not measured" for
every time, each stage the JAX tool also computes bit-identical to it)."""

import functools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from libpillowfight_tpu.core import bitmap as jbitmap
from libpillowfight_tpu.ops import morph as jmorph
from libpillowfight_tpu.ops.pallas import flood_packed as jfp
from libpillowfight_tpu.ops.unpaper import blackfilter as jblack
from libpillowfight_tpu.ops.unpaper import blurfilter as jblur
from libpillowfight_tpu.ops.unpaper import border as jborder
from libpillowfight_tpu.ops.unpaper import common as jcommon
from libpillowfight_tpu.ops.unpaper import grayfilter as jgray
from libpillowfight_tpu.ops.unpaper import masks as jmasks
from libpillowfight_tpu.ops.unpaper import noisefilter as jnoise
from libpillowfight_tpu.parallel import pipeline as jpipe
from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
from libpillowfight_tpu_torch.tools import (
    bench_suite, profile_blackfilter, profile_chain, profile_chain_parts,
    profile_filters, profile_flood, profile_swt, timing)
from libpillowfight_tpu_torch.utils.pages import synthetic_pages

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, H, W = 2, 128, 160       # past the blurfilter's 100-px blocks
FLOOD = (2, 300, 420)       # the flood tool's mask has text lines here
NA = timing.NOT_MEASURED
CPU = torch.device("cpu")
TOOLS = {
    "profile_chain": (profile_chain, dict(b=B, h=H, w=W)),
    "profile_chain_parts": (profile_chain_parts, dict(b=B, h=H, w=W)),
    "profile_blackfilter": (profile_blackfilter, dict(b=B, h=H, w=W)),
    "profile_flood": (profile_flood, dict(zip("bhw", FLOOD))),
    "profile_swt": (profile_swt, dict(b=1, h=120, w=160)),
    "profile_filters": (profile_filters, dict(b=B, h=64, w=80)),
}
LABELS = {
    "profile_chain": [
        "rgba_to_gray", "blackfilter_wipe", "noisefilter_wipe",
        "blurfilter_wipe", "masks_wipe", "grayfilter_wipe", "border_wipe",
        "sum of stages", "fused chain (RGBA u8 in/out)",
        "fused chain (int32 words in/out)"],
    "profile_chain_parts": [
        "blackfilter block_counts 20/5",
        "blackfilter seeds (block_counts + coverage)",
        "blackfilter flood_reach leap=20",
        "noisefilter small_cluster_mask k=4",
        "blurfilter block_counts 100/50", "blurfilter full",
        "grayfilter full (s3 from words)", "dark + nonwhite from gray",
        "rgba_to_gray", "words_to_gray"],
    "profile_blackfilter": [
        "blackfilter_wipe total",
        "statistics (dark + block_counts + coverage)",
        "flood total (leap=20, packed route)",
        "reach plane set to the seeds (copy)",
        "one sweep launch, down + up (leap=20)",
        "one sweep launch, down + up (leap=1)"],
    "profile_flood": [
        "packed flood, max_iters=1", "packed flood, max_iters=2",
        "packed flood, max_iters=4", "sweep flood, max_iters=1",
        "sweep flood, max_iters=2", "sweep flood, max_iters=4",
        "flood_reach (packed route: pack + flood + unpack)",
        "sweep flood to its fixed point"],
    "profile_swt": [
        "gray", "gradients and edges", "width maps, pass 1", "ray medians",
        "width maps, pass 2", profile_swt.KERNEL_STAGE, "labelling",
        "output", "letter statistics", "sum of stages",
        "swt total (mode 0)"],
    "profile_filters": sorted(jpipe._FILTERS),
}


@functools.cache
def run_tool(name):
    """(record, {label: output}) of one tool's measure on the CPU, each
    stage's output taken as `Profile.stage` returns it."""
    mod, kw = TOOLS[name]
    outputs = {}
    stage = timing.Profile.stage

    def spy(self, label, fn, *args):
        outputs[label] = out = stage(self, label, fn, *args)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timing.Profile, "stage", spy)
        rec = mod.measure(**kw, device="cpu")
    return rec, outputs


def np_of(x):
    if isinstance(x, tuple):
        return tuple(np_of(y) for y in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want):
    got, want = np_of(got), np_of(want)
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            assert_same(g, w)
        return
    if want.dtype == np.uint32:  # the reference's words
        want = want.view(np.int32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ bench_torch

def test_imports_leave_jax_out():
    code = ("import sys, chip_smoke, bench_torch, "
            "libpillowfight_tpu_torch.tools.timing, "
            + ", ".join(f"libpillowfight_tpu_torch.tools.{t}" for t in TOOLS)
            + "; assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'bench' not in sys.modules; "
            "assert 'libpillowfight_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=REPO)


@pytest.mark.parametrize("calls", [1, 2])
def test_time_chain_matches_jax_run_pipeline(calls):
    batches = timing.word_batches(B, H, W, CPU)
    seconds, out = timing.time_chain(batches, calls, CPU)
    assert len(seconds) == calls and min(seconds) > 0
    seed = (calls - 1) % 2
    words = jbitmap.host_pages_to_words(synthetic_pages(B, H, W, seed=seed))
    want = jpipe.run_pipeline(jnp.asarray(words),
                              jpipe.normalize_spec(jpipe.DOCUMENT_CLEANUP))
    assert_same(out, want)


def test_bench_main_exits_nonzero_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) != 0
    assert bench_torch.main(["--quick"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_bench_script_exits_nonzero_without_card():
    r = subprocess.run([sys.executable, "bench_torch.py", "--quick"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""


@pytest.fixture
def small_bench(monkeypatch):
    monkeypatch.setattr(bench_torch, "QUICK", (B, H, W))


def test_bench_record(small_bench):
    rec = bench_torch.run(quick=True, device="cpu")
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device",
                        "calls", "ms_min", "ms_max"}
    assert rec["metric"] == "unpaper_cleanup_pipeline_throughput"
    assert rec["unit"] == "MP/s/chip" and rec["device"] == "cpu"
    assert rec["calls"] >= 6 and rec["calls"] % 2 == 1
    # no CPU number goes under a device metric
    assert rec["value"] == rec["ms_min"] == rec["ms_max"] == NA
    assert rec["vs_baseline"] is None
    assert json.loads(json.dumps(rec)) == rec


def test_bench_check_fails_on_a_wrong_page(small_bench):
    want = bench_torch.plain_page(H, W)
    assert not torch.equal(want, timing.word_batches(1, H, W, CPU)[0])
    bench_torch.run(quick=True, device="cpu", plain=want)
    wrong = want.clone()
    wrong[0, 5, 7] ^= 1
    with pytest.raises(AssertionError, match="1 of"):
        bench_torch.run(quick=True, device="cpu", plain=wrong)


def test_bench_leaves_tmp_as_found(small_bench, tmp_path, monkeypatch):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    bench_torch.run(quick=True, device="cpu")
    assert list(tmp.iterdir()) == []


def test_tools_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, kw in TOOLS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.measure(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run(quick=True)


# ------------------------------------------------------- the profile tools

@pytest.mark.parametrize("name", list(TOOLS))
def test_profile_record_on_the_cpu(name):
    rec, _ = run_tool(name)
    assert rec["tool"] == name and rec["device"] == "cpu"
    assert list(rec["ms"]) == LABELS[name]
    assert list(rec["mp_per_s"]) == LABELS[name]
    for key in ("ms", "mp_per_s", "device_ms"):
        assert set(rec.get(key, {}).values()) <= {NA}
    assert json.loads(json.dumps(rec)) == rec


def test_suite_config6_takes_profile_filters():
    assert list(bench_suite.FILTERS) == [
        n for n in profile_filters.FILTERS if n != "swt"]
    assert all(bench_suite.FILTERS[n] is profile_filters.FILTERS[n]
               for n in bench_suite.FILTERS)


@functools.cache
def jax_inputs():
    """The JAX tool's planes for the pages the port's tools take."""
    pages = jnp.asarray(synthetic_pages(B, H, W))
    gray = jbitmap.rgba_to_gray(pages)
    dark = jcommon.dark_mask(gray)
    return {"pages": pages, "gray": gray, "dark": dark,
            "nonwhite": jcommon.nonwhite_mask(gray),
            "words": jbitmap.pages_to_words(pages)}


def jax_seeds(d):
    """The JAX tools' blackfilter seeds (`bf_seed`, `stats`)."""
    counts = jcommon.block_sums(d, 20, 5)
    trig = counts >= (0.95 * 400)
    return jcommon.coverage_from_blocks(trig, d.shape, 20, 5) & d


def jax_packed_rounds(seeds, mask, leap):
    """(reach, rounds) of the reference's packed flood, its rounds run
    one by one as `flood_packed._flood_packed` runs them (two, then more
    while the last changed a word), its kernels in interpret mode."""
    b, h, w = mask.shape
    pad = ((0, 0), (0, 0), (0, -w % 128))
    m = jnp.pad(jnp.asarray(mask, bool), pad)
    s = jnp.pad(jnp.asarray(seeds, bool), pad) & m
    mp, sp = jfp.pack_rows(m), jfp.pack_rows(s)
    pad = ((0, 0), (0, -mp.shape[1] % 8), (0, 0))
    mp, sp = jnp.pad(mp, pad), jnp.pad(sp, pad)
    wp, n_rows = mp.shape[2], mp.shape[1] * 32
    kernels = (functools.partial(jfp._lanes_kernel, width=wp),
               functools.partial(jfp._rows_kernel, n_rows=n_rows),
               functools.partial(jfp._dilate_kernel, width=wp, leap=leap))

    def round_(r):
        r = jfp._phase_call(kernels[0], mp, r, interpret=True)
        r = jfp._phase_call(kernels[1], mp, r, interpret=True)
        return jfp._phase_call(kernels[2], mp, r, n_out=2, interpret=True)

    r, _ = round_(sp & mp)
    r, chg = round_(r)
    rounds = 2
    while int(jnp.sum(chg)) > 0:
        r, chg = round_(r)
        rounds += 1
    return jfp.unpack_rows(r, h, w), rounds


def _chain_wants():
    j = jax_inputs()
    spec = jpipe.normalize_spec(jpipe.DOCUMENT_CLEANUP)
    return {
        "rgba_to_gray": lambda: j["gray"],
        "blackfilter_wipe": lambda: jblack.blackfilter_wipe(j["gray"]),
        "noisefilter_wipe": lambda: jnoise.noisefilter_wipe(j["gray"]),
        "blurfilter_wipe": lambda: jblur.blurfilter_wipe(j["gray"]),
        "masks_wipe": lambda: jmasks.masks_wipe(j["gray"]),
        "grayfilter_wipe": lambda: jgray.grayfilter_wipe(j["gray"]),
        "border_wipe": lambda: jborder.border_wipe(j["gray"]),
        "fused chain (RGBA u8 in/out)":
            lambda: jpipe.run_pipeline(j["pages"], spec),
        "fused chain (int32 words in/out)":
            lambda: jpipe.run_pipeline(j["words"], spec),
    }


def _parts_wants():
    j = jax_inputs()
    return {
        "blackfilter block_counts 20/5":
            lambda: jcommon.block_sums(j["dark"], 20, 5),
        "blackfilter seeds (block_counts + coverage)":
            lambda: jax_seeds(j["dark"]),
        "blackfilter flood_reach leap=20":
            lambda: jmorph.flood_reach(jax_seeds(j["dark"]), j["dark"],
                                       leap=20),
        "noisefilter small_cluster_mask k=4":
            lambda: jmorph.small_cluster_mask(j["nonwhite"], 4),
        "blurfilter block_counts 100/50":
            lambda: jcommon.block_sums(j["nonwhite"], 100, 50),
        "blurfilter full":
            lambda: jblur.blurfilter_wipe_nonwhite(j["nonwhite"]),
        "grayfilter full (s3 from words)":
            lambda: jgray.grayfilter_wipe_planes(j["dark"], j["gray"]),
        "dark + nonwhite from gray": lambda: (j["dark"], j["nonwhite"]),
        "rgba_to_gray": lambda: j["gray"],
        "words_to_gray": lambda: jbitmap.words_to_gray(j["words"]),
    }


@pytest.mark.parametrize("label", LABELS["profile_chain"][:7]
                         + LABELS["profile_chain"][8:])
def test_profile_chain_stage_matches_jax(label):
    assert_same(run_tool("profile_chain")[1][label], _chain_wants()[label]())


@pytest.mark.parametrize("label", LABELS["profile_chain_parts"])
def test_profile_chain_parts_stage_matches_jax(label):
    assert_same(run_tool("profile_chain_parts")[1][label],
                _parts_wants()[label]())


@pytest.mark.parametrize("label", LABELS["profile_blackfilter"][:3])
def test_profile_blackfilter_stage_matches_jax(label):
    got = run_tool("profile_blackfilter")[1][label]
    j = jax_inputs()
    want = {"blackfilter_wipe total":
            lambda: jblack.blackfilter_wipe(j["gray"]),
            "statistics (dark + block_counts + coverage)":
            lambda: jax_seeds(j["dark"]),
            "flood total (leap=20, packed route)":
            lambda: jmorph.flood_reach(jax_seeds(j["dark"]), j["dark"],
                                       leap=20)}[label]()
    assert_same(got, want)


def test_profile_blackfilter_flood_rounds_match_jax():
    j = jax_inputs()
    seeds = jax_seeds(j["dark"])
    rec, _ = run_tool("profile_blackfilter")
    got = profile_blackfilter.flood_count(torch.from_numpy(np.array(seeds)),
                                          torch.from_numpy(np.array(j["dark"])),
                                          20)
    reach, rounds = jax_packed_rounds(seeds, j["dark"], 20)
    assert_same(got["reach"], reach)
    assert_same(got["reach"], jmorph.flood_reach(seeds, j["dark"], leap=20))
    assert got["route"] == "packed" and got["rounds"] == rounds
    assert rec["flood"] == {"route": "packed", "rounds": rounds}


@functools.cache
def flood_inputs():
    seeds, mask = profile_flood.scan_mask(*FLOOD)
    return seeds, mask


@pytest.mark.parametrize("n", profile_flood.ROUNDS)
def test_profile_flood_packed_rounds_match_jax(n):
    seeds, mask = flood_inputs()
    label = f"packed flood, max_iters={n}"
    rec, outs = run_tool("profile_flood")
    want = jfp.flood_reach_packed(jnp.asarray(seeds), jnp.asarray(mask),
                                  max_iters=n, interpret=True)
    assert_same(fp.unpack_rows_plain(outs[label], FLOOD[1]), want)
    # two rounds at least, the flood's own at most
    full = rec["rounds"]["flood_reach (packed route: pack + flood + unpack)"]
    assert rec["rounds"][label] == min(max(n, 2), full)


def test_profile_flood_fixed_points_and_rounds_match_jax():
    seeds, mask = flood_inputs()
    rec, outs = run_tool("profile_flood")
    want = jmorph.flood_reach(jnp.asarray(seeds), jnp.asarray(mask))
    reach, rounds = jax_packed_rounds(seeds, mask, 1)
    assert_same(reach, want)
    assert_same(outs["flood_reach (packed route: pack + flood + unpack)"],
                want)
    assert_same(outs["sweep flood to its fixed point"], want)
    assert rec["rounds"]["flood_reach (packed route: pack + flood + unpack)"] \
        == rounds


def test_profile_swt_stages_give_swt():
    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.core.bitmap import pages_to_words
    from libpillowfight_tpu_torch.utils.pages import text_pages

    words = pages_to_words(torch.from_numpy(text_pages(1, 120, 160)))
    st = profile_swt.swt_stages(words, keep_links=True)
    assert torch.equal(st["out"], pt.swt(words))
    assert st["valid"].shape == words.shape and len(st["links"]) == 4
    assert set(st["ms"].values()) == {NA}
