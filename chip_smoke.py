"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. requires a CUDA card (exits non-zero without one);
2. prints the card's name and power limit (nvidia-smi);
3. builds the kernels of libpillowfight_tpu_torch/csrc with nvcc;
4. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes the port's paths give it on A4 300 dpi pages
   (batch 2), and times both with CUDA events: bit-identical for all but
   the ACE spray, which is held to f32 rounding (rsqrtf);
5. drives four paths through the port's run_pipeline on an A4 x 2 batch
   on the card, each with every launch count set to 0 just before and
   read just after, and checks that each launched its kernels:
   - DOCUMENT_CLEANUP, bit-identical to the plain chain run on the CPU;
   - EDGE_STACK (canny), within the canny bar of the plain stack on the
     CPU (<= 0.1% of edge pixels differ);
   - ace (shared samples drawn from a seed), <= 1 LSB from its plain
     version on the card (the CPU plain at S = 100 on 17 MP is slow);
   - DOCUMENT_CLEANUP with noisefilter intensity 1 (the direct ball
     count), bit-identical to the plain chain on the CPU;
6. times the cleanup chain, EDGE_STACK and ace (100 samples) on A4 x 16
   (two distinct dirty batches, median of CUDA-event times), prints MP/s;
7. prints the kernels line (JSON), then the result line (JSON), last.

Any failed phase raises, and the exit code is then non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

A4_H, A4_W = 3508, 2480
CHECK_BATCH, TIME_BATCH = 2, 16
TIME_ITERS = 6
ACE_SEED = 7
CANNY_BAR = 0.001     # share of edge pixels that may differ
ACE_SPRAY_RTOL = 1e-5  # of the largest possible sum (see check_kernels)

_PALLAS = "libpillowfight_tpu/ops/pallas/"
_CSRC = "libpillowfight_tpu_torch/csrc/"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "line_counts": (_CSRC + "linecount.cu", _PALLAS + "linecount_kernel.py:24"),
    "pack_rows": (_CSRC + "flood_packed.cu", _PALLAS + "flood_packed.py:62"),
    "unpack_rows": (_CSRC + "flood_packed.cu", _PALLAS + "flood_packed.py:71"),
    "flood_round": (_CSRC + "flood_packed.cu", _PALLAS + "flood_packed.py:250"),
    "noise_cert": (_CSRC + "noise_cert.cu", _PALLAS + "noise_kernel.py:223"),
    "noise_ball": (_CSRC + "noise_cert.cu", _PALLAS + "noise_kernel.py:146"),
    "gaussian_sep": (_CSRC + "gaussian_sep.cu",
                     _PALLAS + "gaussian_kernel.py:35"),
    "ace_spray": (_CSRC + "ace_spray.cu", _PALLAS + "ace_kernel.py:33"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn() in ms over iters calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> float:
    """Largest |a - b| over matching outputs (tuples allowed)."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def check_kernels(words2: torch.Tensor) -> dict:
    """Each kernel vs its plain version on one A4 x 2 batch's planes."""
    from libpillowfight_tpu_torch.core import constants as C
    from libpillowfight_tpu_torch.core.bitmap import words_to_gray, words_to_pages
    from libpillowfight_tpu_torch.ops import ace as tace
    from libpillowfight_tpu_torch.ops.conv import gaussian_taps
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import gaussian as gs
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise
    from libpillowfight_tpu_torch.ops.unpaper.common import (
        block_counts, coverage_from_blocks, dark_mask, f32, nonwhite_mask)

    b, h, w = words2.shape
    gray = words_to_gray(words2)  # canny's gray plane of the same pages
    dark, nonwhite = dark_mask(gray), nonwhite_mask(gray)
    # the blackfilter flood's inputs, as the chain builds them
    counts = block_counts(dark, 20, 5)
    seeds = coverage_from_blocks(counts >= f32(380.0, counts), dark.shape,
                                 20, 5) & dark
    seeds_w, dark_w = fp.pack_rows_plain(seeds), fp.pack_rows_plain(dark)
    cert_w, nonwhite_w = noise.noise_cert_plain(nonwhite, 2, 5)
    taps = gaussian_taps(C.CANNY_GAUSSIAN_SIGMA, C.CANNY_GAUSSIAN_NB_STDDEV)
    sy, sx = tace.sample_coords(ACE_SEED, b, C.ACE_DEFAULT_NB_SAMPLES, h, w)
    sy, sx = sy.to(words2.device), sx.to(words2.device)
    planar, sval = tace.spray_inputs(words_to_pages(words2), sy, sx)
    slope, limit = C.ACE_DEFAULT_SLOPE, C.ACE_DEFAULT_LIMIT

    def exact(got, want):
        err = max_abs_err(got, want)
        return err, err == 0.0

    def spray_bar(got, want):
        """Every term |clip(.) * inv_d| <= limit * inv_d, so |num| <=
        limit * invd; rsqrtf is ~2 ulp from the plain rsqrt, and the
        sums run in the same order: both outputs are held to
        ACE_SPRAY_RTOL of their largest possible magnitude."""
        bound = float(want[1].max())
        err_n, err_i = max_abs_err(got[0], want[0]), max_abs_err(got[1],
                                                                 want[1])
        ok = (err_n <= ACE_SPRAY_RTOL * limit * bound
              and err_i <= ACE_SPRAY_RTOL * bound)
        return max(err_n, err_i), ok

    cases = {
        "line_counts": (lambda: lc.line_counts_cuda(dark),
                        lambda: lc.line_counts_plain(dark), exact),
        "pack_rows": (lambda: fp.pack_rows_cuda(dark),
                      lambda: fp.pack_rows_plain(dark), exact),
        "unpack_rows": (lambda: fp.unpack_rows_cuda(dark_w, h),
                        lambda: fp.unpack_rows_plain(dark_w, h), exact),
        "flood_round": (
            lambda: fp.flood_packed_cuda(seeds_w, dark_w, h, w, leap=20),
            lambda: fp.flood_packed_plain(seeds_w, dark_w, h, w, leap=20),
            exact),
        "noise_cert": (lambda: noise.noise_cert_cuda(nonwhite, 2, 5),
                       lambda: noise.noise_cert_plain(nonwhite, 2, 5), exact),
        "noise_ball": (lambda: noise.noise_ball_cuda(nonwhite, 1),
                       lambda: noise.noise_ball_plain(nonwhite, 1), exact),
        "gaussian_sep": (lambda: gs.gaussian_sep_cuda(gray, taps),
                         lambda: gs.gaussian_sep_plain(gray, taps), exact),
        "ace_spray": (
            lambda: spray.ace_spray_cuda(planar, sy, sx, sval, slope, limit),
            lambda: spray.ace_spray_plain(planar, sy, sx, sval, slope, limit),
            spray_bar),
    }
    out = {}
    for name, (kernel, plain, bar) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = bar(got, want)
        if not ok:
            raise AssertionError(f"{name}: kernel differs from plain, "
                                 f"max |diff| {err}")
        out[name] = {"max_abs_err": err, "ms": cuda_ms(kernel),
                     "plain_ms": cuda_ms(plain)}
        log(f"kernel {name}: max |diff| {err}; {out[name]['ms']:.4f} ms vs "
            f"plain {out[name]['plain_ms']:.4f} ms")
    # the noisefilter flood (leap 1, from certificates) too
    got = fp.flood_packed_cuda(cert_w, nonwhite_w, h, w, leap=1)
    want = fp.flood_packed_plain(cert_w, nonwhite_w, h, w, leap=1)
    if max_abs_err(got, want) != 0.0:
        raise AssertionError("flood_round at leap 1 differs from plain")
    log("kernel flood_round (leap 1, noisefilter inputs): bit-identical")
    # the other board radii the sweeps are built for, on a 512-row strip
    part = nonwhite[:, :512].contiguous()
    for j in range(1, noise.MAX_J + 1):
        if max_abs_err(noise.noise_cert_cuda(part, j, 2 * j + 1),
                       noise.noise_cert_plain(part, j, 2 * j + 1)) != 0.0:
            raise AssertionError(f"noise_cert at j={j} differs from plain")
    log(f"kernel noise_cert j=1..{noise.MAX_J}: bit-identical (A4 x 2, 512 rows)")
    for k in range(2, noise.MAX_K + 1):
        if max_abs_err(noise.noise_ball_cuda(part, k),
                       noise.noise_ball_plain(part, k)) != 0.0:
            raise AssertionError(f"noise_ball at k={k} differs from plain")
    log(f"kernel noise_ball k=2..{noise.MAX_K}: bit-identical (A4 x 2, 512 rows)")
    return out


def _counters():
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import gaussian as gs
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise
    return spray, fp, gs, lc, noise


def launch_counts() -> dict:
    spray, fp, gs, lc, noise = _counters()
    return {"line_counts": lc.launches, **fp.launches, **noise.launches,
            "gaussian_sep": gs.launches, "ace_spray": spray.launches}


def reset_launch_counts() -> None:
    spray, fp, gs, lc, noise = _counters()
    lc.launches = gs.launches = spray.launches = 0
    for d in (fp.launches, noise.launches):
        for k in d:
            d[k] = 0


def counted(fn, name: str, expect: list) -> tuple:
    """Run fn() with every launch count at 0 before; fail unless each
    kernel of `expect` launched. Returns (output, counts)."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{name} launches: {counts}")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by {name}: {missing}")
    return out, counts


def check_chain(out_gpu, words2_cpu, spec, name: str) -> None:
    """Bit-identical to the plain chain on the CPU, and a real wipe."""
    import libpillowfight_tpu_torch as pt

    t0 = time.perf_counter()
    out_cpu = pt.run_pipeline(words2_cpu, spec)
    log(f"{name}: plain on the CPU (A4 x {CHECK_BATCH}) "
        f"{time.perf_counter() - t0:.1f} s")
    if not torch.equal(out_gpu.cpu(), out_cpu):
        n = int((out_gpu.cpu() != out_cpu).sum())
        raise AssertionError(f"{name} on the card differs from the plain "
                             f"chain on {n} pixels")
    changed = int((out_cpu != words2_cpu).sum())
    if out_cpu.shape != words2_cpu.shape or changed == 0:
        raise AssertionError(f"{name} output {tuple(out_cpu.shape)} "
                             f"wiped {changed} pixels")
    log(f"{name} A4 x {CHECK_BATCH}: bit-identical to the plain chain "
        f"({changed} pixels wiped)")


def check_edges(out_gpu, words2_cpu, spec) -> None:
    """EDGE_STACK within the canny bar of the plain stack on the CPU."""
    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.core.bitmap import words_to_pages

    t0 = time.perf_counter()
    want = words_to_pages(pt.run_pipeline(words2_cpu, spec))
    log(f"edge stack: plain on the CPU (A4 x {CHECK_BATCH}) "
        f"{time.perf_counter() - t0:.1f} s")
    got = words_to_pages(out_gpu.cpu())
    edges = int((want[..., 0] > 0).sum())
    differ = int((got[..., 0] != want[..., 0]).sum())
    if got.shape != want.shape or edges == 0 or differ > CANNY_BAR * edges:
        raise AssertionError(f"edge stack: {differ} of {edges} edge pixels "
                             f"differ (bar {CANNY_BAR:.1%})")
    if not (torch.equal(got[..., 0], got[..., 1])
            and torch.equal(got[..., 0], got[..., 2])
            and bool((got[..., 3] == 255).all())):
        raise AssertionError("edge stack: output is not gray RGBA")
    log(f"edge stack A4 x {CHECK_BATCH}: {differ} of {edges} edge pixels "
        f"differ from the plain stack (bar {CANNY_BAR:.1%})")


def check_ace(out_gpu, words2) -> None:
    """ace on the card <= 1 LSB from its plain version on the card, on
    the samples the seed draws."""
    from libpillowfight_tpu_torch.core import constants as C
    from libpillowfight_tpu_torch.core.bitmap import words_to_pages
    from libpillowfight_tpu_torch.ops import ace as tace
    from libpillowfight_tpu_torch.ops.cuda import ace as spray

    pages = words_to_pages(words2)
    b, h, w, _ = pages.shape
    sy, sx = tace.sample_coords(ACE_SEED, b, C.ACE_DEFAULT_NB_SAMPLES, h, w)
    sy, sx = sy.to(pages.device), sx.to(pages.device)
    planar, sval = tace.spray_inputs(pages, sy, sx)
    num, invd = spray.ace_spray_plain(planar, sy, sx, sval,
                                      C.ACE_DEFAULT_SLOPE, C.ACE_DEFAULT_LIMIT)
    want = tace.from_spray(pages, num, invd, C.ACE_DEFAULT_LIMIT)
    got = words_to_pages(out_gpu)
    lsb = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    n = int((got != want).sum())
    if got.shape != want.shape or lsb > 1:
        raise AssertionError(f"ace: {lsb} LSB from the plain version")
    spread = got[..., :3].to(torch.int32)
    if int(spread.min()) > 5 or int(spread.max()) < 250:
        raise AssertionError("ace: output not stretched to the full range")
    log(f"ace A4 x {CHECK_BATCH}: max {lsb} LSB from the plain version on "
        f"the card ({n} bytes differ)")


def time_path(fn, batches, name: str, card: str) -> float:
    fn(batches[0])  # warm-up
    torch.cuda.synchronize()
    times = []
    for i in range(TIME_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(batches[i % 2])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    ms = statistics.median(times)
    mp = TIME_BATCH * A4_H * A4_W / 1e6
    log(f"{name} A4 x {TIME_BATCH}: median {ms:.2f} ms over {TIME_ITERS} "
        f"(all: {', '.join(f'{t:.2f}' for t in times)}); "
        f"{mp / (ms / 1e3):.2f} MP/s on {card}")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from bench import _pages

    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path().name})")

    cleanup = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
    edges = pt.normalize_spec(pt.EDGE_STACK)
    ace_spec = pt.normalize_spec([("ace", {"seed": ACE_SEED})])
    cleanup_k1 = pt.normalize_spec(
        [("unpaper_noisefilter", {"intensity": 1}) if name ==
         "unpaper_noisefilter" else (name, kw)
         for name, kw in pt.DOCUMENT_CLEANUP])
    pages2 = _pages(CHECK_BATCH, A4_H, A4_W)
    words2_cpu = torch.from_numpy(pages2).view(torch.int32).squeeze(-1)
    words2 = words2_cpu.to(dev)

    # 4. each kernel vs its plain version
    timings = check_kernels(words2)

    # 5. the paths on the card, each counted
    total = dict.fromkeys(KERNELS, 0)

    def drive(spec, name, expect):
        out, counts = counted(lambda: pt.run_pipeline(words2, spec), name,
                              expect)
        for k in total:
            total[k] += counts[k]
        return out

    out = drive(cleanup, "cleanup chain",
                ["line_counts", "pack_rows", "unpack_rows", "flood_round",
                 "noise_cert"])
    check_chain(out, words2_cpu, cleanup, "cleanup chain")
    out = drive(edges, "edge stack",
                ["gaussian_sep", "pack_rows", "flood_round", "unpack_rows"])
    check_edges(out, words2_cpu, edges)
    out = drive(ace_spec, "ace", ["ace_spray"])
    check_ace(out, words2)
    out = drive(cleanup_k1, "cleanup chain, noisefilter intensity 1",
                ["line_counts", "pack_rows", "unpack_rows", "flood_round",
                 "noise_ball"])
    check_chain(out, words2_cpu, cleanup_k1, "cleanup chain k=1")
    del out

    # 6. throughput at A4 x 16, two distinct dirty batches
    batches = [torch.from_numpy(_pages(TIME_BATCH, A4_H, A4_W, seed=s))
               .view(torch.int32).squeeze(-1).to(dev) for s in (0, 1)]
    ms = time_path(lambda x: pt.run_pipeline(x, cleanup), batches,
                   "chain", card)
    log(f"unpaper_cleanup_pipeline_throughput "
        f"{TIME_BATCH * A4_H * A4_W / 1e3 / ms:.2f} MP/s")
    time_path(lambda x: pt.run_pipeline(x, edges), batches, "EDGE_STACK",
              card)
    time_path(lambda x: pt.run_pipeline(x, ace_spec), batches,
              "ace (100 samples)", card)
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": total[name], **timings[name]}
               for name, (src, rep) in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
