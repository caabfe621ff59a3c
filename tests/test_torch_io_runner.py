"""The port's page IO, batch runner, heartbeat and metrics against the
JAX package's, on the CPU.

The io copy's outputs equal the reference module's (through the native
codec and the pure-numpy fallback); the runner with `devices=["cpu"]`
gives the JAX runner's pages bit for bit, resumes, retries, steals from a
dead host, and shares its manifest and heartbeat files with the JAX
package in both directions. Importing the port loads neither jax nor the
JAX package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from libpillowfight_tpu import io as jio
from libpillowfight_tpu.core import bitmap as jbitmap
from libpillowfight_tpu.parallel import BatchRunner as JaxRunner
from libpillowfight_tpu.parallel import Heartbeat as JaxHeartbeat
from libpillowfight_tpu_torch import io as tio
from libpillowfight_tpu_torch.core import bitmap as tbitmap
from libpillowfight_tpu_torch.parallel import (DOCUMENT_CLEANUP, BatchRunner,
                                               Heartbeat, map_chunked,
                                               normalize_spec, run_pipeline)
from libpillowfight_tpu_torch.parallel.batch import BatchMetrics
from libpillowfight_tpu_torch.utils import metrics
from libpillowfight_tpu_torch.utils.pages import synthetic_pages

# one thread for torch: these pages are small, and beside the other
# workers' XLA compiles a thread pool only waits for its own threads
torch.set_num_threads(1)

H, W = 96, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pages(n: int) -> np.ndarray:
    """n distinct dirty pages: each its own speckles and a bar whose row
    follows the page's index."""
    pages = np.concatenate([synthetic_pages(1, H, W, seed=i)
                            for i in range(n)])
    for i in range(n):
        y = 12 + (5 * i) % (H - 24)
        pages[i, y:y + 2, 20:20 + 4 * (i + 1), :3] = 40
    return pages


def _collect(out: dict):
    def sink(idx, pages):
        for i, j in enumerate(idx):
            assert int(j) not in out, f"page {j} delivered twice"
            out[int(j)] = np.array(pages[i])
    return sink


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """The port's io through the native libpfio.so and through the
    pure-numpy fallback (forced by nulling its `_load`)."""
    if request.param == "python":
        monkeypatch.setattr(tio, "_load", lambda: None)
    elif not tio.available():
        pytest.skip("native libpfio not built")
    return request.param


# ---------------------------------------------------------------- page IO


def test_ppm_roundtrip_vs_reference(codec, rng, tmp_path):
    img = _img(rng, 37, 53)
    p, q = str(tmp_path / "x.ppm"), str(tmp_path / "ref.ppm")
    tio.write_ppm(p, img)
    jio.write_ppm(q, img)
    assert open(p, "rb").read() == open(q, "rb").read()
    back = tio.decode_pnm(p)
    assert back.shape == (37, 53, 4)
    np.testing.assert_array_equal(back, jio.decode_pnm(p))
    np.testing.assert_array_equal(back[..., :3], img)
    assert (back[..., 3] == 255).all()


def test_pgm_roundtrip_vs_reference(codec, rng, tmp_path):
    gray = rng.integers(0, 256, (30, 20), dtype=np.uint8)
    p, q = str(tmp_path / "x.pgm"), str(tmp_path / "ref.pgm")
    tio.write_pgm(p, gray)
    jio.write_pgm(q, gray)
    assert open(p, "rb").read() == open(q, "rb").read()
    back = tio.decode_pnm(p)
    np.testing.assert_array_equal(back, jio.decode_pnm(p))
    np.testing.assert_array_equal(back[..., 0], gray)
    np.testing.assert_array_equal(back[..., 0], back[..., 1])


def test_ascii_pnm_and_maxval_vs_reference(codec, tmp_path):
    a, m = str(tmp_path / "a.pgm"), str(tmp_path / "m.ppm")
    with open(a, "w") as f:
        f.write("P2\n# comment\n3 2\n255\n0 128 255\n10 20 30\n")
    with open(m, "w") as f:
        f.write("P3\n2 1\n100\n0 50 100 100 0 7\n")
    back = tio.decode_pnm(a)
    np.testing.assert_array_equal(back[..., 0], [[0, 128, 255], [10, 20, 30]])
    np.testing.assert_array_equal(back, jio.decode_pnm(a))
    back = tio.decode_pnm(m)
    np.testing.assert_array_equal(back[0, :, :3], [[0, 128, 255],
                                                   [255, 0, 18]])
    np.testing.assert_array_equal(back, jio.decode_pnm(m))


def test_decode_error(codec, tmp_path):
    p = str(tmp_path / "bad.ppm")
    with open(p, "wb") as f:
        f.write(b"not a pnm")
    with pytest.raises(ValueError):
        tio.decode_pnm(p)


def test_pnm_source_pads_crops_and_prefetches_vs_reference(codec, rng,
                                                           tmp_path):
    paths, imgs = [], []
    for i in range(7):
        img = _img(rng, 20 + 3 * i, 50 - 2 * i)
        p = str(tmp_path / f"p{i}.ppm")
        tio.write_ppm(p, img)
        paths.append(p)
        imgs.append(img)
    with tio.PnmPageSource(paths, shape=(32, 44)) as src:
        assert len(src) == 7
        got = np.concatenate([src(np.arange(s, min(s + 3, 7))).copy()
                              for s in range(0, 7, 3)])
        assert src.failed == 0
    with jio.PnmPageSource(paths, shape=(32, 44)) as ref:
        want = np.concatenate([ref(np.arange(s, min(s + 3, 7))).copy()
                               for s in range(0, 7, 3)])
    np.testing.assert_array_equal(got, want)
    for i, img in enumerate(imgs):
        ch, cw = min(32, img.shape[0]), min(44, img.shape[1])
        np.testing.assert_array_equal(got[i, :ch, :cw, :3], img[:ch, :cw])
        assert (got[i, ch:] == 255).all() and (got[i, :, cw:] == 255).all()


def test_pnm_source_random_access_and_failures(codec, rng, tmp_path):
    good = str(tmp_path / "g.ppm")
    tio.write_ppm(good, _img(rng, 8, 8))
    bad = str(tmp_path / "missing.ppm")
    with tio.PnmPageSource([good, bad, good], shape=(8, 8)) as src:
        out = src(np.array([2, 0, 1]))  # non-contiguous path
        assert out.shape == (3, 8, 8, 4)
        assert (out[2] == 255).all()    # failed page -> white
        assert src.failed == 1
        with jio.PnmPageSource([good, bad, good], shape=(8, 8)) as ref:
            np.testing.assert_array_equal(out, ref(np.array([2, 0, 1])))


def test_image_source_vs_reference(codec, rng, tmp_path):
    from PIL import Image

    paths = []
    for i in range(5):
        g = (rng.random((10 + i, 12 - i)) * 255).astype(np.uint8)
        p = str(tmp_path / f"r{i}.png")
        Image.fromarray(g).convert("RGB").save(p)
        paths.append(p)
    q = str(tmp_path / "r5.ppm")
    tio.write_ppm(q, _img(rng, 9, 14))
    paths += [q, str(tmp_path / "missing.png")]
    runs = []
    for io in (tio, jio):
        with io.ImagePageSource(paths, shape=(11, 12)) as src:
            a = src(np.arange(0, 3)).copy()    # triggers prefetch of 3..5
            b = src(np.arange(3, 6)).copy()    # consumes the prefetch
            c = src(np.array([6, 1, 0])).copy()  # random access + missing
            runs.append((a, b, c, src.failed))
    for x, y in zip(*runs):
        np.testing.assert_array_equal(x, y)
    # missing.png fails twice: once in the drained prefetch of [6], once
    # in the random-access decode
    assert runs[0][3] == 2 and (runs[0][2][0] == 255).all()


def test_ppm_sink_vs_reference(codec, rng, tmp_path):
    pages = np.stack([_img(rng, 6, 7), _img(rng, 6, 7)])
    rgba = np.concatenate([pages, np.full((2, 6, 7, 1), 255, np.uint8)], -1)
    tio.PpmSink(str(tmp_path / "t"))(np.array([3, 9]), rgba)
    jio.PpmSink(str(tmp_path / "j"))(np.array([3, 9]), rgba)
    for name in ("page_000003.ppm", "page_000009.ppm"):
        assert (open(tmp_path / "t" / name, "rb").read()
                == open(tmp_path / "j" / name, "rb").read())
    back = tio.decode_pnm(str(tmp_path / "t" / "page_000009.ppm"))
    np.testing.assert_array_equal(back[..., :3], pages[1])


def test_bitmap_host_helpers_vs_reference(rng, tmp_path):
    from PIL import Image

    page = np.concatenate([_img(rng, 5, 6), rng.integers(
        0, 256, (5, 6, 1), dtype=np.uint8)], -1)
    img = Image.fromarray(page, mode="RGBA").convert("RGB")
    np.testing.assert_array_equal(tbitmap.from_pil(img),
                                  jbitmap.from_pil(img))
    np.testing.assert_array_equal(np.asarray(tbitmap.to_pil(page)),
                                  np.asarray(jbitmap.to_pil(page)))
    for i, arr in enumerate((page, page[..., :3], page[..., 0])):
        p, q = tmp_path / f"t{i}.ppm", tmp_path / f"j{i}.ppm"
        tbitmap.write_ppm(str(p), arr)
        jbitmap.write_ppm(str(q), arr)
        assert p.read_bytes() == q.read_bytes()
    batch = np.stack([page, page[::-1]])
    words = tbitmap.host_pages_to_words(batch)
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, jbitmap.host_pages_to_words(batch))
    np.testing.assert_array_equal(tbitmap.host_words_to_pages(words), batch)
    np.testing.assert_array_equal(
        tbitmap.host_words_to_pages(words.view(np.int32)), batch)
    # the port's int32 words are the same bytes
    np.testing.assert_array_equal(
        tbitmap.pages_to_words(torch.from_numpy(batch)).numpy(),
        words.view(np.int32))


def test_fresh_process_imports_no_jax():
    code = ("import sys, libpillowfight_tpu_torch, pillowfight_torch; "
            "import libpillowfight_tpu_torch.parallel.batch; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'libpillowfight_tpu' "
            "or m.startswith('libpillowfight_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------- the runner


def test_runner_bit_identical_to_jax_runner():
    pages = _pages(10)
    got, want = {}, {}
    m = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"]).run(
        10, lambda idx: pages[idx], _collect(got))
    JaxRunner(DOCUMENT_CLEANUP, chunk_size=4).run(
        10, lambda idx: pages[idx], _collect(want))
    assert m.pages == 10 and m.chunks == 3
    assert m.megapixels == pytest.approx(10 * H * W / 1e6)
    assert sorted(got) == sorted(want) == list(range(10))
    whole = run_pipeline(torch.from_numpy(pages),
                         normalize_spec(DOCUMENT_CLEANUP)).numpy()
    for j in range(10):
        np.testing.assert_array_equal(got[j], want[j])
        np.testing.assert_array_equal(got[j], whole[j])
    assert (whole != pages).any()


def test_runner_resume(tmp_path):
    pages = _pages(12)
    manifest = str(tmp_path / "run.manifest")
    calls = []

    def source(idx):
        calls.append(tuple(idx))
        return pages[idx]

    seen = {}
    runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"],
                         manifest_path=manifest)
    m = runner.run(12, source, _collect(seen))
    assert m.pages == 12 and m.chunks == 3 and len(seen) == 12
    lines = [json.loads(x) for x in open(manifest)]
    assert [x["start"] for x in lines] == [0, 4, 8]
    assert all(set(x) == {"start", "n", "dt", "host"} for x in lines)
    # resume: a fresh runner skips everything already done
    runner2 = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"],
                          manifest_path=manifest)
    m2 = runner2.run(12, source, _collect({}))
    assert m2.pages == 0 and m2.chunks == 0 and len(calls) == 3


def test_runner_retries_runtime_errors_only():
    pages = _pages(8)
    runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"])
    fn, calls = runner.fn, []

    def flaky(x):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("transient device failure")
        return fn(x)

    runner.fn = flaky
    seen = {}
    m = runner.run(8, lambda idx: pages[idx], _collect(seen))
    assert m.retries == 1 and m.pages == 8 and len(calls) == 3
    whole = run_pipeline(torch.from_numpy(pages),
                         normalize_spec(DOCUMENT_CLEANUP)).numpy()
    for j in range(8):
        np.testing.assert_array_equal(seen[j], whole[j])

    def broken(x):
        calls.append(1)
        raise ValueError("a programming error")

    runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"])
    runner.fn, calls[:] = broken, []
    with pytest.raises(ValueError, match="a programming error"):
        runner.run(8, lambda idx: pages[idx])
    assert len(calls) == 1  # not retried


def test_runner_steals_from_dead_host(tmp_path):
    """A 2-host batch where host 1 dies after one chunk: host 0 detects
    the stale heartbeat and reprocesses host 1's unfinished chunk (a real
    child process, crashed)."""
    import glob

    tmp = str(tmp_path)
    child_src = f"""
import numpy as np, os
from libpillowfight_tpu_torch.parallel import BatchRunner, Heartbeat
from libpillowfight_tpu_torch.parallel.batch import BatchMetrics
from libpillowfight_tpu_torch.parallel.pipeline import DOCUMENT_CLEANUP
hb = Heartbeat({tmp!r} + "/hb", interval=0.2, timeout=1.0,
               host_id=1, n_hosts=2).start()
pages = np.full((4, 64, 64, 4), 255, np.uint8)
r = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"],
                manifest_path={tmp!r} + "/m.jsonl", host_id=1, n_hosts=2)
r._process_chunk(4, 16, lambda idx: pages, None, BatchMetrics())
os._exit(1)  # crash: chunk 12 (also host 1's) never happens
"""
    proc = subprocess.run([sys.executable, "-c", child_src], cwd=REPO,
                          timeout=300)
    assert proc.returncode == 1  # simulated crash

    hb0 = Heartbeat(tmp + "/hb", interval=0.2, timeout=1.0,
                    host_id=0, n_hosts=2).start()
    pages = np.full((4, 64, 64, 4), 255, np.uint8)
    seen = []
    runner = BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"],
                         manifest_path=tmp + "/m.jsonl", host_id=0,
                         n_hosts=2, heartbeat=hb0, steal_poll=0.2)
    m = runner.run(16, lambda idx: pages, lambda idx, out: seen.extend(idx))
    hb0.stop()
    assert m.stolen == 1 and m.chunks == 3   # own 0, 8 + stolen 12
    assert sorted(seen) == list(range(0, 4)) + list(range(8, 16))
    starts = sorted(json.loads(x)["start"] for x in open(tmp + "/m.jsonl"))
    assert starts == [0, 4, 8, 12]  # whole batch complete exactly once
    assert glob.glob(tmp + "/m.jsonl.claim.*") == []


def _jax_run(manifest, n, source, sink):
    return JaxRunner(DOCUMENT_CLEANUP, chunk_size=4,
                     manifest_path=manifest).run(n, source, sink)


def _torch_run(manifest, n, source, sink):
    return BatchRunner(DOCUMENT_CLEANUP, chunk_size=4, devices=["cpu"],
                       manifest_path=manifest).run(n, source, sink)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_manifest_resumes_across_packages(tmp_path, first):
    """A run killed at the third chunk by its source, resumed under the
    other package: every page is delivered once, only what was left is
    processed the second time, and the pages are the chain's."""
    pages = _pages(14)
    manifest = str(tmp_path / "m.jsonl")
    runs = [_jax_run, _torch_run] if first == "jax" else [_torch_run,
                                                          _jax_run]
    seen = {}

    def dying(idx):
        if idx[0] == 8:
            raise ValueError("source died")
        return pages[idx]

    with pytest.raises(ValueError, match="source died"):
        runs[0](manifest, 14, dying, _collect(seen))
    done = sorted(json.loads(x)["start"] for x in open(manifest))
    assert done == [0] and sorted(seen) == [0, 1, 2, 3]
    loaded = []

    def source(idx):
        loaded.append(int(idx[0]))
        return pages[idx]

    m = runs[1](manifest, 14, source, _collect(seen))
    assert sorted(loaded) == [4, 8, 12] and m.pages == 10
    assert sorted(seen) == list(range(14))
    lines = [json.loads(x) for x in open(manifest)]
    assert sorted(x["start"] for x in lines) == [0, 4, 8, 12]
    assert [x["n"] for x in sorted(lines, key=lambda x: x["start"])] == \
        [4, 4, 4, 2]
    whole = run_pipeline(torch.from_numpy(pages),
                         normalize_spec(DOCUMENT_CLEANUP)).numpy()
    for j in range(14):
        np.testing.assert_array_equal(seen[j], whole[j])


@pytest.mark.parametrize("spec", [DOCUMENT_CLEANUP, ()],
                         ids=["cleanup", "empty"])
@pytest.mark.parametrize("kind", ["one_buffer", "image_source"])
def test_reused_source_buffer(tmp_path, spec, kind):
    """A source that hands out views of one buffer it overwrites on each
    call (as `ImagePageSource` does with its double buffer) gives the
    pages of a source that hands out fresh arrays. The empty spec returns
    its input, so a runner that kept the source's buffer would deliver
    the next chunk's pages."""
    pages = _pages(11)
    fresh = {}
    BatchRunner(spec, chunk_size=3, devices=["cpu"]).run(
        11, lambda idx: pages[idx].copy(), _collect(fresh))
    reused = {}
    if kind == "one_buffer":
        buf = np.empty((3, H, W, 4), np.uint8)

        def source(idx):
            buf[:len(idx)] = pages[idx]
            return buf[:len(idx)]

        BatchRunner(spec, chunk_size=3, devices=["cpu"]).run(
            11, source, _collect(reused))
    else:
        paths = []
        for i, page in enumerate(pages):
            paths.append(str(tmp_path / f"p{i}.ppm"))
            tio.write_ppm(paths[-1], page)
        with tio.ImagePageSource(paths, shape=(H, W)) as src:
            BatchRunner(spec, chunk_size=3, devices=["cpu"]).run(
                11, src, _collect(reused))
            assert src.failed == 0
    assert sorted(reused) == sorted(fresh) == list(range(11))
    for j in range(11):
        np.testing.assert_array_equal(reused[j], fresh[j])
    if not spec:
        np.testing.assert_array_equal(np.stack([fresh[j] for j in range(11)]),
                                      pages)


def test_runner_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRunner(DOCUMENT_CLEANUP)
    with pytest.raises(ValueError, match="work stealing"):
        BatchRunner(DOCUMENT_CLEANUP, devices=["cpu"],
                    heartbeat=object())


def test_batch_metrics_to_dict():
    m = BatchMetrics(pages=8, megapixels=2.0, seconds=4.0, chunks=2)
    assert m.pages_per_sec == 2.0 and m.mp_per_sec == 0.5
    assert m.to_dict() == {"pages": 8, "megapixels": 2.0, "seconds": 4.0,
                           "pages_per_sec": 2.0, "mp_per_sec": 0.5,
                           "chunks": 2, "retries": 0, "stolen": 0}
    assert BatchMetrics().pages_per_sec == 0.0


# ------------------------------------------------------ heartbeat, metrics


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_heartbeat_read_across_packages(tmp_path, writer):
    d = str(tmp_path)
    cls_w, cls_r = ((Heartbeat, JaxHeartbeat) if writer == "torch"
                    else (JaxHeartbeat, Heartbeat))
    hb = cls_w(d, interval=0.05, timeout=0.5, host_id=0, n_hosts=2).start()
    reader = cls_r(d, interval=0.05, timeout=0.5, host_id=1, n_hosts=2)
    time.sleep(0.3)
    assert reader.stale_hosts() == [1]   # host 1 never beat
    beat = json.load(open(os.path.join(d, "host0.hb")))
    assert set(beat) == {"seq", "t"} and beat["seq"] >= 1
    hb.stop()
    time.sleep(0.7)
    assert reader.stale_hosts() == [0, 1]


def test_heartbeat_env_defaults(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    hb = Heartbeat(str(tmp_path))
    assert (hb.host_id, hb.n_hosts) == (2, 3)
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    hb = Heartbeat(str(tmp_path))
    assert (hb.host_id, hb.n_hosts) == (0, 1)


def test_meter_and_roofline(monkeypatch):
    monkeypatch.setattr(metrics, "_PEAK_HBM_BW", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        metrics.roofline(1.0, 100)   # no peak set and no card to measure
    with pytest.raises(RuntimeError):
        metrics.device_time(lambda: None)
    metrics.set_peak_hbm_bw(1e12)
    r = metrics.roofline(0.5, 2e11)
    assert r.achieved_bw == 4e11 and r.peak_bw == 1e12
    assert r.fraction_of_roofline == pytest.approx(0.4)
    assert str(r) == "400.0 GB/s achieved of 1000 GB/s peak (40.0% of roofline)"
    m = metrics.Meter().start()
    m.record(4, 1000, 500)
    m.record(2, 1000, 500)
    assert m.pages == 6 and m.megapixels == pytest.approx(3.0)
    assert m.seconds > 0 and m.pages_per_sec == pytest.approx(6 / m.seconds)
    assert metrics.Meter().mp_per_sec == 0.0


def test_timed_fetch_and_trace(tmp_path):
    x = torch.ones(4)
    seconds, out = metrics.timed_fetch(lambda t: t * 2, x, iters=3)
    assert seconds >= 0 and torch.equal(out, torch.full((4,), 8.0))
    with metrics.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_map_chunked():
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(map_chunked(lambda t: t * 2, x, 2), x * 2)
    assert torch.equal(map_chunked(lambda t: t + 1, x, 8), x + 1)
    with pytest.raises(ValueError, match="not divisible"):
        map_chunked(lambda t: t, x, 4)
