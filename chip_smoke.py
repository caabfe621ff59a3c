"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. requires a CUDA card (exits non-zero without one);
2. prints the card's name and power limit (nvidia-smi);
3. builds the kernels of libpillowfight_tpu_torch/csrc with nvcc;
4. holds each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes the cleanup chain gives it on A4 300 dpi pages
   (batch 2), bit-identical, and times both with CUDA events;
5. runs DOCUMENT_CLEANUP through the port's run_pipeline on an A4 x 2
   batch on the card, with every launch count set to 0 just before, and
   checks the output bit-identical to the plain chain run on the CPU;
6. times the chain on A4 x 16 (two distinct dirty batches, median of
   CUDA-event times) and prints MP/s;
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

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "line_counts": ("libpillowfight_tpu_torch/csrc/linecount.cu",
                    "libpillowfight_tpu/ops/pallas/linecount_kernel.py:24"),
    "pack_rows": ("libpillowfight_tpu_torch/csrc/flood_packed.cu",
                  "libpillowfight_tpu/ops/pallas/flood_packed.py:62"),
    "unpack_rows": ("libpillowfight_tpu_torch/csrc/flood_packed.cu",
                    "libpillowfight_tpu/ops/pallas/flood_packed.py:71"),
    "flood_round": ("libpillowfight_tpu_torch/csrc/flood_packed.cu",
                    "libpillowfight_tpu/ops/pallas/flood_packed.py:250"),
    "noise_cert": ("libpillowfight_tpu_torch/csrc/noise_cert.cu",
                   "libpillowfight_tpu/ops/pallas/noise_kernel.py:223"),
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
    from libpillowfight_tpu_torch.core.bitmap import words_to_gray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise
    from libpillowfight_tpu_torch.ops.unpaper.common import (
        block_counts, coverage_from_blocks, dark_mask, f32, nonwhite_mask)

    h, w = words2.shape[1:]
    gray = words_to_gray(words2)
    dark, nonwhite = dark_mask(gray), nonwhite_mask(gray)
    # the blackfilter flood's inputs, as the chain builds them
    counts = block_counts(dark, 20, 5)
    seeds = coverage_from_blocks(counts >= f32(380.0, counts), dark.shape,
                                 20, 5) & dark
    seeds_w, dark_w = fp.pack_rows_plain(seeds), fp.pack_rows_plain(dark)
    cert_w, nonwhite_w = noise.noise_cert_plain(nonwhite, 2, 5)

    cases = {
        "line_counts": (lambda: lc.line_counts_cuda(dark),
                        lambda: lc.line_counts_plain(dark)),
        "pack_rows": (lambda: fp.pack_rows_cuda(dark),
                      lambda: fp.pack_rows_plain(dark)),
        "unpack_rows": (lambda: fp.unpack_rows_cuda(dark_w, h),
                        lambda: fp.unpack_rows_plain(dark_w, h)),
        "flood_round": (
            lambda: fp.flood_packed_cuda(seeds_w, dark_w, h, w, leap=20),
            lambda: fp.flood_packed_plain(seeds_w, dark_w, h, w, leap=20)),
        "noise_cert": (lambda: noise.noise_cert_cuda(nonwhite, 2, 5),
                       lambda: noise.noise_cert_plain(nonwhite, 2, 5)),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from plain, "
                                 f"max |diff| {err}")
        out[name] = {"max_abs_err": err, "ms": cuda_ms(kernel),
                     "plain_ms": cuda_ms(plain)}
        log(f"kernel {name}: bit-identical; {out[name]['ms']:.4f} ms vs "
            f"plain {out[name]['plain_ms']:.4f} ms")
    # the noisefilter flood (leap 1, from certificates) too
    got = fp.flood_packed_cuda(cert_w, nonwhite_w, h, w, leap=1)
    want = fp.flood_packed_plain(cert_w, nonwhite_w, h, w, leap=1)
    if max_abs_err(got, want) != 0.0:
        raise AssertionError("flood_round at leap 1 differs from plain")
    log("kernel flood_round (leap 1, noisefilter inputs): bit-identical")
    # the other board radii the certificate kernel is built for (k != 4)
    part = nonwhite[:, :512].contiguous()
    for j in range(1, noise.MAX_J + 1):
        if max_abs_err(noise.noise_cert_cuda(part, j, 2 * j + 1),
                       noise.noise_cert_plain(part, j, 2 * j + 1)) != 0.0:
            raise AssertionError(f"noise_cert at j={j} differs from plain")
    log(f"kernel noise_cert j=1..{noise.MAX_J}: bit-identical (A4 x 2, 512 rows)")
    return out


def launch_counts() -> dict:
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise

    return {"line_counts": lc.launches, **fp.launches,
            "noise_cert": noise.launches}


def reset_launch_counts() -> None:
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise

    lc.launches = 0
    noise.launches = 0
    for k in fp.launches:
        fp.launches[k] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from bench import _pages

    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch import _build

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

    spec = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
    pages2 = _pages(CHECK_BATCH, A4_H, A4_W)
    words2_cpu = torch.from_numpy(pages2).view(torch.int32).squeeze(-1)
    words2 = words2_cpu.to(dev)

    # 4. each kernel vs its plain version
    timings = check_kernels(words2)

    # 5. the main path on the card, counted, vs the plain chain on the CPU
    reset_launch_counts()
    out_gpu = pt.run_pipeline(words2, spec)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"main path launches: {launches}")
    t0 = time.perf_counter()
    out_cpu = pt.run_pipeline(words2_cpu, spec)
    log(f"plain chain on the CPU (A4 x {CHECK_BATCH}): "
        f"{time.perf_counter() - t0:.1f} s")
    if not torch.equal(out_gpu.cpu(), out_cpu):
        n = int((out_gpu.cpu() != out_cpu).sum())
        raise AssertionError(f"chain on the card differs from the plain "
                             f"chain on {n} pixels")
    changed = int((out_cpu != words2_cpu).sum())
    if out_cpu.shape != words2_cpu.shape or changed == 0:
        raise AssertionError(f"chain output {tuple(out_cpu.shape)} "
                             f"wiped {changed} pixels")
    log(f"chain A4 x {CHECK_BATCH}: bit-identical to the plain chain "
        f"({changed} pixels wiped)")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: "
                             f"{missing}")

    # 6. chain throughput at A4 x 16, two distinct dirty batches
    batches = [torch.from_numpy(_pages(TIME_BATCH, A4_H, A4_W, seed=s))
               .view(torch.int32).squeeze(-1).to(dev) for s in (0, 1)]
    pt.run_pipeline(batches[0], spec)  # warm-up
    torch.cuda.synchronize()
    times = []
    for i in range(TIME_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pt.run_pipeline(batches[i % 2], spec)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    ms = statistics.median(times)
    mp = TIME_BATCH * A4_H * A4_W / 1e6
    log(f"chain A4 x {TIME_BATCH}: median {ms:.2f} ms over {TIME_ITERS} "
        f"(all: {', '.join(f'{t:.2f}' for t in times)}); "
        f"unpaper_cleanup_pipeline_throughput {mp / (ms / 1e3):.2f} MP/s "
        f"on {card}")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **timings[name]}
               for name, (src, rep) in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
