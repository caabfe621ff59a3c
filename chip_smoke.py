"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR   # see `against` below
    python3 chip_smoke.py --issue-rates   # the card's f32 issue rates

1. requires a CUDA card (exits non-zero without one);
2. prints the card's name and power limit (nvidia-smi);
3. builds the kernels of libpillowfight_tpu_torch/csrc with nvcc;
4. holds each of the ten kernels against its plain PyTorch version on the
   same CUDA tensors, at the shapes the port's paths give it (A4 300 dpi
   x 2; the sweep flood at A4 600 dpi x 2), and times both with CUDA
   events: bit-identical for all but the ACE spray, which is held to f32
   rounding (rsqrtf). Beside each time it prints the kernel's bound (the
   least time the card could take: compulsory bytes over the memory rate,
   or operations over the f32 rate) and, where one PyTorch call computes
   the same function, that call's time, and each call three ways: the
   kernel's device time (the profiler's rows of its device functions),
   the wrapper's other device operations, its host time. Both floods are also held to
   their plain versions on the shared edge cases of
   `utils.pages.flood_cases` (heights around a 32-row band, widths around
   a strip, leaps 1 to 33, snakes, a solid ring, no seeds) and on random
   planes up to leap 70, with their sweeps and rounds per flood; the
   label kernel on the shared edge cases of `utils.pages.label_cases`
   (planes around its tile and its loads, snakes, a spiral, diagonal-only
   links, links off the page), bit-identical; the ACE spray's measured
   error at a default, a steep and a shallow slope for 1, 100 and 1000
   samples, in both forms of its channel term; `flood_reach` 4-connected
   and `compare` on the card against the same call on the CPU; the blur
   bit-identical on the RGB planes of A4 x 2, the gray planes of A4 600
   dpi x 2, at 1, 3, 21 and 97 taps and on `utils.pages.blur_cases` (both
   of its instances launched); the line counts bit-identical on the dark
   planes at 300 and 600 dpi, an all-dark and an empty plane and on
   `utils.pages.line_count_cases`; the pack bit-identical on the dark
   planes at 300 and 600 dpi and on `utils.pages.pack_cases` (every load
   width, heights up to A4's, uint8 values, unaligned views); the unpack
   bit-identical on the dark planes' words at 300 and 600 dpi and on
   `utils.pages.unpack_cases` (every store width, heights up to A4's,
   unaligned word views); the certificate sweep bit-identical on the
   non-white plane at 600 dpi and on `utils.pages.cert_cases` at j =
   1..8; the ball count on the non-white plane at 600 dpi (k = 1) and on
   `utils.pages.cert_cases` at k = 1..15. A kernel whose event time or
   device time reads under its bound fails the run (a device time under a
   byte bound, possible while the inputs sit in L2, is taken again with
   L2 evicted by a 256 MB read, and that time is held to the bound; the
   unpack, whose output at A4 x 2 fits in L2, is also timed at A4 600 dpi
   x 2, and if even its time with L2 evicted reads under the bound at A4
   x 2, the bound is held at 600 dpi);
5. drives six paths through the port's run_pipeline on the card, each
   with every launch count set to 0 just before and read just after, and
   checks that each launched its kernels:
   - DOCUMENT_CLEANUP at A4 x 2, bit-identical to the plain chain run on
     the CPU;
   - EDGE_STACK (canny), within the canny bar of the plain stack on the
     CPU (<= 0.1% of edge pixels differ);
   - ace (shared samples drawn from a seed), <= 1 LSB from its plain
     version on the card;
   - DOCUMENT_CLEANUP with noisefilter intensity 1 (the direct ball
     count), bit-identical to the plain chain on the CPU;
   - swt (mode 0) at A4 x 2 on pages with glyphs: bit-identical to the
     same swt with every kernel's plain version on the card, letters
     found, and on a small page of the same kind within the SWT bar
     (letter-mask IoU >= 0.99) of swt on the CPU (a crop would not do:
     canny's thresholds follow the page's rim); modes 1 and 2 once each,
     checked against the letter mask and the boxes the stage functions
     give;
   - DOCUMENT_CLEANUP at A4 600 dpi x 2 (the sweep flood's route),
     bit-identical to the plain chain on the CPU;
   then (5b) holds one A4 page through the card's gaussian and sobel
   (<= 1 LSB), canny (at most max(0.1% of the oracle's edge pixels, 2)
   differ), each of the six unpaper filters (wiped-region IoU >= 0.99,
   under 1% of pixels differ), swt mode 0 (letter-mask IoU >= 0.99 on a
   `bar_pages` page; on a `text_pages` page, where the reference itself
   reads ~0.9, a reading only) and ace with 16 shared samples injected
   into both (<= 1 LSB) to the C oracle (`utils.oracle`, built with
   make), at the bars of the reference's oracle tests, each call counted;
6. times swt, the cleanup chain, EDGE_STACK and ace (100 samples) on
   A4 x 16 and the cleanup chain, EDGE_STACK, ace and swt on A4 600 dpi
   x 4 (two distinct dirty batches, median of CUDA-event times), prints
   MP/s, swt's peak device memory at both sizes, the stages of swt and
   the device's idle share during swt; the packed flood alone at A4 x 16
   and the sweep flood alone at A4 600 dpi x 4, the shapes those paths
   give them;
   then the chain's `utils.metrics.device_time` beside its time, and the
   card's copy bandwidth by `utils.metrics.measure_peak_hbm_bw`;
7. drives the façade and the runner on the card, each call with every
   launch count set to 0 just before and read just after:
   - the façade's 13 functions on one A4 page (through
     `pillowfight_torch` on PIL images where PIL imports, else through
     the façade's private numpy functions, and it says which), each
     launching the kernels of `FACADE_KERNELS` (sobel, blurfilter,
     grayfilter, compare and ace in its default mode "rolled" none), each
     held to the same call with device="cpu" at the bar of ROADMAP.md
     (swt and ace on a SWT_SMALL page); ace in mode "shared" once (the
     spray kernel, also held to its plain version on the card at A4) and
     the blackfilter once on an A4 600 dpi page (the sweep flood);
   - DOCUMENT_CLEANUP over 64 A4 pages read from 16 PPM files (written by
     the port's `io.write_ppm` under chiprun_out/) through
     `io.ImagePageSource` -> `parallel.BatchRunner`, chunk 16: every page
     delivered once, bit-identical to run_pipeline on the card; then the
     same run killed at the third chunk by its source and resumed from its
     manifest;
   - config 5 (BASELINE.json configs[4]): DOCUMENT_CLEANUP + swt over 128
     A4 pages read from 16 `text_pages` PPM files the same way, every page
     bit-identical to run_pipeline on the card; pages/s and MP/s over the
     wall clock from the first source call to the last sink (decode and
     both copies in, the files in the page cache), the time spent
     waiting on the source, and the device's idle share from one profiled
     chunk; the files are deleted afterwards;
7b. drives the distribution layer on the card, each call counted:
   `parallel.dryrun_multichip(4, devices=["cuda:0"] * 4)` (and over
   every card where there are several); the rows-sharded chain at A4 x 4
   on (2, 2) shards and at A4 600 dpi x 2 on (1, 2) shards (the sweep
   flood) and (1, 4) shards (the packed flood), bit-identical to the
   unsharded chain, with the flood's exchange rounds; `sharded_stencil`
   of the blur on A4 gray planes against the unsharded blur; the
   rows-sharded chain timed beside the unsharded one at A4 x 16 on (1, 2)
   shards of one card;
8. runs the headline measurement of `bench_torch.py` once at A4 x 16
   (its checked page held to the plain chain of phase 5) and the profile
   tools of `libpillowfight_tpu_torch/tools/` at their default sizes
   (`profile_chain` and `profile_blackfilter` also at A4 600 dpi x 2),
   each counted, each record printed, every stage's time above 0;
9. prints the kernels line (JSON; beside the contract's keys each kernel
   has `kernel_ms`, `other_device_ms` and `host_ms`; `launches` sums the
   counted paths of 5, 5b, 7, 7b and 8), then the result line (JSON), last.

Any failed phase raises, and the exit code is then non-zero.

With `--against DIR`, where DIR holds another tree of this repository (for
example `git archive <parent> | tar -x -C .scratch/parent`), the script
loads that tree's package beside this one in one process and takes the
two in turns (other, this, this, other) on the same tensors: the blur
(gray and RGB planes of A4 x 2, gray planes of A4 600 dpi x 2), the line
counts and the pack (dark planes at 300 and 600 dpi), the unpack (their
words), the certificate sweep (non-white planes at 300 and 600 dpi, j =
2) and the ball count (the same planes, k = 1), each also a call three
ways, their outputs compared bit for bit; this tree's
certificate sweep alone on an empty and a full plane; the label kernel
and the ACE spray at A4 x 2, with their outputs compared bit for bit,
the device time of each call split by kernel name; the five timed
paths, and the device time a run of the chain at 300 and 600 dpi by the
profiler. It prints one JSON object and writes it to
`chiprun_out/against.json`.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

from libpillowfight_tpu_torch.tools.profile_swt import swt_stages
from libpillowfight_tpu_torch.utils.metrics import (
    ACE_SLOTS_PER_PIXEL_SAMPLE, F32_OPS_PER_S, HBM_BYTES_PER_S, SFU_OPS_PER_S,
    card_name_and_power)

A4_H, A4_W = 3508, 2480
A4_600_H, A4_600_W = 7016, 4960
CHECK_BATCH, TIME_BATCH, TIME_BATCH_600 = 2, 16, 4
TIME_ITERS = 6
ACE_SEED = 7
CANNY_BAR = 0.001     # share of edge pixels that may differ
SWT_IOU_BAR = 0.99    # letter-mask IoU, card against CPU
SWT_SMALL = (800, 1000)  # a page the CPU takes about ten seconds for

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
    "label_links": (_CSRC + "label_links.cu", _PALLAS + "flood_kernel.py:382"),
    "flood_sweep": (_CSRC + "flood_sweep.cu", _PALLAS + "flood_kernel.py:156"),
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: float = 0.0, n_sfu: float = 0.0) -> dict:
    """The least time for the work: each input read once and each output
    written once at the card's memory rate, or the f32 operations at the
    card's rate outside the tensor cores (an instruction that is no FMA
    counts 2, the FMA it keeps from issuing), or the special-function
    results at their rate, whichever is longest."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(n_ops / F32_OPS_PER_S, n_sfu / SFU_OPS_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def spray_errors(got, want) -> tuple:
    """(max |num diff|, max |invd diff|, max invd) of two spray results.
    Every term |clip(.) * inv_d| <= limit * inv_d, so |num| <= limit *
    invd: the bar `ACE_SPRAY_RTOL` (`ops/cuda/ace.py`) holds num to that
    share of limit * max(invd) and invd to that share of max(invd)."""
    return (max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]),
            float(want[1].max()))


def words_on(pages, dev) -> torch.Tensor:
    """uint8 RGBA pages (numpy) -> int32 words on dev."""
    return torch.from_numpy(pages).view(torch.int32).squeeze(-1).to(dev)


def blackfilter_flood_inputs(gray):
    """(seeds, dark) of the blackfilter's flood, as the chain builds
    them."""
    from libpillowfight_tpu_torch.ops.unpaper.blackfilter import (
        blackfilter_seeds)
    from libpillowfight_tpu_torch.ops.unpaper.common import dark_mask

    dark = dark_mask(gray)
    seeds = blackfilter_seeds(dark)
    return seeds, dark


def packed_flood(seeds, mask, leap: int):
    """The packed route of `flood_reach` on bool planes: pack, flood,
    unpack."""
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp

    h, w = mask.shape[1:]
    return fp.unpack_rows_cuda(fp.flood_packed_cuda(
        fp.pack_rows_cuda(seeds), fp.pack_rows_cuda(mask), h, w, leap=leap),
        h)


def time_sweep_flood(seeds, mask, leap: int, what: str) -> float:
    """The sweep flood's time, its launches and sweeps, the time a sweep."""
    from libpillowfight_tpu_torch.ops.cuda import flood_sweep as fs

    before = fs.launches
    fs.flood_sweep_cuda(seeds, mask, leap=leap)
    n = fs.launches - before
    ms = cuda_ms(lambda: fs.flood_sweep_cuda(seeds, mask, leap=leap))
    log(f"flood_sweep, {what}, leap {leap}: {ms:.4f} ms a flood in {n} "
        f"launches = {2 * n} sweeps, {ms / (2 * n):.4f} ms a sweep")
    return ms


def time_packed_flood(seeds_w, mask_w, h: int, w: int, leap: int,
                      what: str) -> float:
    """The packed flood's time (packed planes in and out), its rounds,
    the time a round."""
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp

    fp.flood_packed_cuda(seeds_w, mask_w, h, w, leap=leap)
    n = fp.rounds_of_last_flood()
    ms = cuda_ms(lambda: fp.flood_packed_cuda(seeds_w, mask_w, h, w,
                                              leap=leap))
    log(f"flood_round, {what}, leap {leap}: {ms:.4f} ms a flood in one "
        f"launch of {n} rounds, {ms / n:.4f} ms a round")
    return ms


def check_flood_cases(dev) -> None:
    """Both floods against their plain versions on the shared edge cases,
    the packed flood also under a cap of 2 and of 3 rounds."""
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import flood_sweep as fs
    from libpillowfight_tpu_torch.utils.pages import flood_cases

    notes = []
    for name, seeds, mask, leap in flood_cases():
        seeds, mask = torch.from_numpy(seeds).to(dev), torch.from_numpy(
            mask).to(dev)
        h, w = mask.shape[1:]
        want = fs.flood_sweep_plain(seeds, mask, leap=leap)
        before = fs.launches
        if not torch.equal(fs.flood_sweep_cuda(seeds, mask, leap=leap), want):
            raise AssertionError(f"flood_sweep differs from plain on the "
                                 f"edge case {name}")
        n_launches = fs.launches - before
        seeds_w, mask_w = fp.pack_rows_cuda(seeds), fp.pack_rows_cuda(mask)
        for cap in (None, 2, 3):
            got = fp.flood_packed_cuda(seeds_w, mask_w, h, w, leap=leap,
                                       max_iters=cap)
            if not torch.equal(got, fp.flood_packed_plain(
                    seeds_w, mask_w, h, w, leap=leap, max_iters=cap)):
                raise AssertionError(f"flood_round differs from plain on "
                                     f"the edge case {name}, max_iters={cap}")
            if cap is None:
                rounds = fp.rounds_of_last_flood()
                if not torch.equal(fp.unpack_rows_cuda(got, h), want):
                    raise AssertionError(f"the two floods differ on the "
                                         f"edge case {name}")
        notes.append(f"{name} {2 * n_launches}/{rounds}")
    log(f"flood_sweep and flood_round on {len(notes)} shared edge cases: "
        f"bit-identical to plain and to each other (sweeps/rounds: "
        + ", ".join(notes) + ")")


def check_label_cases(dev) -> None:
    """The label kernel against its plain version on the shared edge
    cases, bit-identical."""
    from libpillowfight_tpu_torch.ops.cuda import label as lb
    from libpillowfight_tpu_torch.utils.pages import label_cases

    notes = []
    for name, valid, links in label_cases():
        valid = torch.from_numpy(valid).to(dev)
        if links is not None:
            links = {d: torch.from_numpy(v).to(dev) for d, v in links.items()}
        got = lb.label_links_cuda(valid, links)
        want = lb.label_links_plain(valid, links)
        if not torch.equal(got, want):
            n = int((got != want).sum())
            raise AssertionError(f"label_links differs from plain on the "
                                 f"edge case {name} ({n} pixels)")
        h, w = valid.shape[1:]
        flat = torch.arange(h * w, device=dev, dtype=torch.int32).view(1, h, w)
        notes.append(f"{name} {int((got == flat).sum())}")
    log(f"label_links on {len(notes)} shared edge cases: bit-identical to "
        f"plain (components: " + ", ".join(notes) + ")")


def blur_planes_rgb(words) -> torch.Tensor:
    """The f32 RGB planes [3B,H,W] the `gaussian` filter blurs."""
    from libpillowfight_tpu_torch.core.bitmap import words_to_pages

    pages = words_to_pages(words)
    b, h, w, _ = pages.shape
    return (pages[..., :3].permute(0, 3, 1, 2).to(torch.float32)
            .reshape(b * 3, h, w).contiguous())


def check_blur_cases(gray, rgb, gray600) -> None:
    """The blur kernel against its plain version, bit-identical: on the
    gray planes of A4 x 2 (canny's) and of A4 600 dpi x 2, on the RGB
    planes of A4 x 2 (the `gaussian` filter's), at 1, 3, 21 and 97 taps on
    the gray planes, and on the shared edge cases of
    `utils.pages.blur_cases`; both instances must launch."""
    from libpillowfight_tpu_torch.ops.conv import gaussian_taps
    from libpillowfight_tpu_torch.ops.cuda import gaussian as gs
    from libpillowfight_tpu_torch.utils.pages import blur_cases, offset_view

    before = dict(gs.instance_launches)
    runs = [("gray A4 x 2", gray, gaussian_taps(2.0, 5)),
            ("RGB planes A4 x 2", rgb, gaussian_taps(2.0, 5)),
            ("gray A4 600 dpi x 2", gray600, gaussian_taps(2.0, 5))]
    for sigma, nb in ((2.0, 0), (0.8, 1), (8.0, 6)):
        taps = gaussian_taps(sigma, nb)
        runs.append((f"gray A4 x 2, {len(taps)} taps", gray, taps))
    for name, planes, taps, offset in blur_cases():
        planes = torch.from_numpy(planes).to(gray.device)
        if offset:
            planes = offset_view(planes, offset)
        runs.append((f"case {name}", planes, taps))
    notes = []
    for what, planes, taps in runs:
        was = dict(gs.instance_launches)
        got = gs.gaussian_sep_cuda(planes, taps)
        want = gs.gaussian_sep_plain(planes, taps)
        if not torch.equal(got, want):
            n = int((got != want).sum())
            raise AssertionError(f"gaussian_sep differs from plain on {what} "
                                 f"({n} pixels)")
        which = [k for k in was if gs.instance_launches[k] > was[k]]
        if which != [gs.kernel_instance(taps)]:
            raise AssertionError(f"gaussian_sep on {what}: instance {which} "
                                 f"launched, {gs.kernel_instance(taps)} "
                                 f"expected")
        notes.append(f"{what} ({which[0]})")
        del got, want
    launched = {k: gs.instance_launches[k] - before[k] for k in before}
    if min(launched.values()) == 0:
        raise AssertionError(f"gaussian_sep instances launched: {launched}")
    log(f"kernel gaussian_sep bit-identical to plain on {len(notes)} inputs, "
        f"launches by instance {launched}: " + "; ".join(notes))


def check_line_count_cases(dark, dark600) -> None:
    """The line-count kernel against its plain version, bit-identical: on
    the chain's dark planes at A4 300 and 600 dpi x 2, an all-dark and an
    empty A4 x 2 plane, and the shared edge cases of
    `utils.pages.line_count_cases`."""
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.utils.pages import (line_count_cases,
                                                      offset_view)

    runs = [("dark A4 x 2", dark), ("dark A4 600 dpi x 2", dark600),
            ("all-dark A4 x 2", torch.ones_like(dark)),
            ("empty A4 x 2", torch.zeros_like(dark))]
    for name, plane, offset in line_count_cases():
        plane = torch.from_numpy(plane).to(dark.device)
        if offset:
            plane = offset_view(plane, offset)
        runs.append((f"case {name}", plane))
    for what, plane in runs:
        got, want = lc.line_counts_cuda(plane), lc.line_counts_plain(plane)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"line_counts differs from plain on {what}")
    log(f"kernel line_counts bit-identical to plain on {len(runs)} inputs: "
        + ", ".join(w for w, _ in runs))


def check_pack_cases(dark, dark600) -> None:
    """The pack kernel against its plain version, bit-identical: on the
    chain's dark planes at A4 300 and 600 dpi x 2 and on the shared edge
    cases of `utils.pages.pack_cases` (every load width, heights around a
    word row up to A4's, all-dark, empty, uint8 values, unaligned views)."""
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.utils.pages import offset_view, pack_cases

    runs = [("dark A4 x 2", dark), ("dark A4 600 dpi x 2", dark600)]
    for name, plane, offset in pack_cases():
        plane = torch.from_numpy(plane).to(dark.device)
        runs.append((f"case {name}", offset_view(plane, offset) if offset
                     else plane))
    for what, plane in runs:
        if not torch.equal(fp.pack_rows_cuda(plane),
                           fp.pack_rows_plain(plane)):
            raise AssertionError(f"pack_rows differs from plain on {what}")
    log(f"kernel pack_rows bit-identical to plain on {len(runs)} inputs: "
        + ", ".join(w for w, _ in runs))


def check_cert_cases(nonwhite, nonwhite600) -> None:
    """The certificate kernel against its plain version, bit-identical:
    on the chain's non-white plane at A4 600 dpi x 2 (j = 2, thresh = 5,
    the path's), and on the shared edge cases of `utils.pages.cert_cases`
    at j = 1..8, each at thresh 2j+1 (k = 2j), 1 (every mask pixel) and
    (2j+1)^2 (no early stop)."""
    from libpillowfight_tpu_torch.ops.cuda import noise
    from libpillowfight_tpu_torch.utils.pages import cert_cases, offset_view

    if max_abs_err(noise.noise_cert_cuda(nonwhite600, 2, 5),
                   noise.noise_cert_plain(nonwhite600, 2, 5)) != 0.0:
        raise AssertionError("noise_cert differs from plain at A4 600 dpi")
    runs = 0
    for name, plane, offset in cert_cases():
        plane = torch.from_numpy(plane).to(nonwhite.device)
        if offset:
            plane = offset_view(plane, offset)
        for j in range(1, noise.MAX_J + 1):
            for thresh in (2 * j + 1, 1, (2 * j + 1) ** 2):
                if max_abs_err(noise.noise_cert_cuda(plane, j, thresh),
                               noise.noise_cert_plain(plane, j, thresh)) != 0:
                    raise AssertionError(f"noise_cert differs from plain on "
                                         f"the edge case {name}, j={j}, "
                                         f"thresh={thresh}")
                runs += 1
    log(f"kernel noise_cert bit-identical to plain at A4 600 dpi x "
        f"{nonwhite600.shape[0]} and on {len(cert_cases())} shared edge cases "
        f"({runs} runs: j = 1..{noise.MAX_J}, thresh 2j+1, 1, (2j+1)^2)")



def check_unpack_cases(dark_w, dark600_w, h: int, h6: int) -> None:
    """The unpack kernel against its plain version, bit-identical: on the
    words of the chain's dark planes at A4 300 and 600 dpi x 2 and on the
    shared edge cases of `utils.pages.unpack_cases` (every store width,
    heights around a word row up to A4's, unaligned word views)."""
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.utils.pages import offset_view, unpack_cases

    runs = [("dark A4 x 2", dark_w, h), ("dark A4 600 dpi x 2", dark600_w, h6)]
    for name, plane, offset in unpack_cases():
        words = fp.pack_rows_plain(torch.from_numpy(plane).to(dark_w.device))
        runs.append((f"case {name}", offset_view(words, offset) if offset
                     else words, plane.shape[1]))
    for what, words, rows in runs:
        if not torch.equal(fp.unpack_rows_cuda(words, rows),
                           fp.unpack_rows_plain(words, rows)):
            raise AssertionError(f"unpack_rows differs from plain on {what}")
    log(f"kernel unpack_rows bit-identical to plain on {len(runs)} inputs: "
        + ", ".join(w for w, _, _ in runs))


def check_ball_cases(nonwhite600) -> None:
    """The ball-count kernel against its plain version, bit-identical: on
    the chain's non-white plane at A4 600 dpi x 2 at k = 1 (the path's),
    and on the shared edge cases of `utils.pages.cert_cases` at k =
    1..15."""
    from libpillowfight_tpu_torch.ops.cuda import noise
    from libpillowfight_tpu_torch.utils.pages import cert_cases, offset_view

    if not torch.equal(noise.noise_ball_cuda(nonwhite600, 1),
                       noise.noise_ball_plain(nonwhite600, 1)):
        raise AssertionError("noise_ball differs from plain at A4 600 dpi")
    runs = 0
    for name, plane, offset in cert_cases():
        plane = torch.from_numpy(plane).to(nonwhite600.device)
        if offset:
            plane = offset_view(plane, offset)
        for k in range(1, noise.MAX_K + 1):
            if not torch.equal(noise.noise_ball_cuda(plane, k),
                               noise.noise_ball_plain(plane, k)):
                raise AssertionError(f"noise_ball differs from plain on the "
                                     f"edge case {name}, k={k}")
            runs += 1
    log(f"kernel noise_ball bit-identical to plain at A4 600 dpi x "
        f"{nonwhite600.shape[0]} (k = 1) and on {len(cert_cases())} shared "
        f"edge cases ({runs} runs: k = 1..{noise.MAX_K})")

def three_way(fn, kernels: tuple, iters: int = 200) -> dict:
    """One wrapper call three ways: its kernel's device time (the
    profiler's rows that name one of the device functions `kernels`), the
    device time of the wrapper's other operations, and the host time of a
    call (`time.perf_counter` over `iters` calls with no sync between; a
    wrapper that waits for its kernel, or a queue that fills, makes it
    read device time too), ms."""
    split = device_split(fn, kernels=kernels)
    kernel = kernel_time(split, kernels)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return {"kernel_ms": round(kernel, 5),
            "other_device_ms": round(sum(split.values()) - kernel, 5),
            "host_ms": round(host, 5), "by_name": split}


def kernel_time(split: dict, kernels: tuple) -> float:
    """The device ms of `split` (by kernel name) in rows that name one of
    the device functions `kernels`."""
    return sum(v for k, v in split.items()
               if any(re.search(rf"(?<!\w){n}(?!\w)", k) for n in kernels))


def held_reading(r: dict, fn, name: str, what: str) -> str:
    """The key of the device time of `r` that is held to its bound: the
    kernel's device time, or, where that reads under a byte bound, its
    time with L2 evicted (`cold_kernel_ms`, added to `r`)."""
    if r["kernel_ms"] >= r["bound_ms"] or r["bound_by"] != "bytes":
        return "kernel_ms"
    # an input that the plain version has just read may sit in L2, which
    # is faster than device memory, so a warm read may beat the byte
    # bound: the read from device memory may not
    r["cold_kernel_ms"] = cold_kernel_ms(fn, DEVICE_FUNCTIONS[name])
    log(f"kernel {name}, {what}: {r['kernel_ms']} ms of device time with its "
        f"inputs in L2, under its byte bound; {r['cold_kernel_ms']} ms with "
        f"L2 evicted")
    return "cold_kernel_ms"


def cold_kernel_ms(fn, kernels: tuple) -> float:
    """Device time of fn()'s kernels with the 50 MB L2 evicted before each
    call by a 256 MB read: its inputs come from device memory, and the
    lines it evicts are clean (a write would leave dirty lines to write
    back during fn)."""
    flush = torch.ones(2**26, dtype=torch.int32, device="cuda")

    def cold():
        flush.sum()
        fn()

    return round(kernel_time(device_split(cold, kernels=kernels), kernels),
                 5)


BLUR_KERNELS = ("blur_strip_kernel", "blur_tile_kernel", "gaussian_sep_kernel")
LINE_COUNT_KERNELS = ("line_counts_kernel",)
DEVICE_FUNCTIONS = {  # name in KERNELS -> the __global__ functions it launches
    "line_counts": LINE_COUNT_KERNELS,
    "pack_rows": ("pack_rows_kernel",),
    "unpack_rows": ("unpack_rows_kernel",),
    "flood_round": ("flood_kernel",),
    "noise_cert": ("noise_cert_kernel",),
    "noise_ball": ("noise_ball_kernel",),
    "gaussian_sep": BLUR_KERNELS,
    "ace_spray": ("ace_spray_kernel",),
    "label_links": ("tile_kernel", "border_kernel", "flatten_kernel"),
    "flood_sweep": ("sweep_kernel",),
}


def check_spray_errors(words2) -> None:
    """The ACE spray kernel's error against its plain version at A4 x 2,
    for 1, 100 and 1000 samples at the default, a steep and a shallow
    slope, in both forms of the channel term; every one inside the bar."""
    from libpillowfight_tpu_torch.core import constants as C
    from libpillowfight_tpu_torch.core.bitmap import words_to_pages
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

    pages = words_to_pages(words2)
    b, h, w, _ = pages.shape
    limit = C.ACE_DEFAULT_LIMIT
    rows = []
    for s in (1, 100, 1000):
        sy, sx = tace.sample_coords(ACE_SEED + s, b, s, h, w)
        sy, sx = sy.to(pages.device), sx.to(pages.device)
        planar, sval = tace.spray_inputs(pages, sy, sx)
        for what, slope in (("default", C.ACE_DEFAULT_SLOPE), ("steep", 1e5),
                            ("shallow", 0.05)):
            want = spray.ace_spray_plain(planar, sy, sx, sval, slope, limit)
            forms = {"exact difference": False}
            if abs(slope) / (2 * limit) * 255 <= spray.PRESCALED_MAX_KI:
                forms["prescaled"] = True
            for form, prescaled in forms.items():
                got = spray.ace_spray_cuda(planar, sy, sx, sval, slope, limit,
                                           prescaled=prescaled)
                err_n, err_i, top = spray_errors(got, want)
                rel_n, rel_i = err_n / (limit * top), err_i / top
                rows.append(f"S={s} {what} ({form}): num {rel_n:.2e}, invd "
                            f"{rel_i:.2e}")
                if max(rel_n, rel_i) > spray.ACE_SPRAY_RTOL:
                    raise AssertionError(
                        f"ace_spray at S={s}, slope {slope}, {form}: error "
                        f"{max(rel_n, rel_i)} past {spray.ACE_SPRAY_RTOL}")
            del want, got
    log(f"kernel ace_spray A4 x {b}, error against plain as a share of the "
        f"largest possible sum (bar {spray.ACE_SPRAY_RTOL}): "
        + "; ".join(rows))


def check_flood4_and_compare(words2, gray) -> None:
    """`flood_reach` 4-connected and `compare` on the card against the
    same calls on the CPU, bit-identical (plain torch on both devices)."""
    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.core.bitmap import words_to_pages
    from libpillowfight_tpu_torch.ops.morph import flood_reach

    from libpillowfight_tpu_torch.ops.unpaper.common import dark_mask

    # the dark pixels of a corner of the page, flooded from its first
    # column (the black border)
    dark = dark_mask(gray)[:, :1200, :900].contiguous()
    seeds = torch.zeros_like(dark)
    seeds[:, :, 0] = dark[:, :, 0]
    got = flood_reach(seeds, dark, connectivity=4)
    want = flood_reach(seeds.cpu(), dark.cpu(), connectivity=4)
    if not torch.equal(got.cpu(), want) or int(want.sum()) == 0:
        raise AssertionError("flood_reach 4-connected on the card differs "
                             "from the CPU")
    log(f"flood_reach connectivity=4 {tuple(want.shape)}: bit-identical to "
        f"the CPU ({int(want.sum())} pixels reached)")
    pages = words_to_pages(words2)
    other = words_to_pages(pt.run_pipeline(
        words2, pt.normalize_spec([("unpaper_noisefilter", {})])))
    for tol in (0, 100):
        n, diff = pt.compare(pages, other, tolerance=tol)
        n_cpu, diff_cpu = pt.compare(pages.cpu(), other.cpu(), tolerance=tol)
        if not (torch.equal(n.cpu(), n_cpu)
                and torch.equal(diff.cpu(), diff_cpu)):
            raise AssertionError(f"compare (tolerance {tol}) on the card "
                                 f"differs from the CPU")
        log(f"compare A4 x {pages.shape[0]}, tolerance {tol}: bit-identical "
            f"to the CPU, differing pixels a page {n.tolist()}")
    if int(n_cpu.sum()) == 0:
        raise AssertionError("compare: the noisefilter changed no pixel")


def check_kernels(words2, swt2: dict, words600) -> dict:
    """Each kernel vs its plain version: on one A4 x 2 batch's planes,
    on the planes SWT builds on an A4 x 2 batch with glyphs (`swt2`), and
    the sweep flood on an A4 600 dpi x 2 batch."""
    import torch.nn.functional as F

    from libpillowfight_tpu_torch.core import constants as C
    from libpillowfight_tpu_torch.core.bitmap import words_to_gray, words_to_pages
    from libpillowfight_tpu_torch.ops.conv import gaussian_taps
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import flood_sweep as fs
    from libpillowfight_tpu_torch.ops.cuda import gaussian as gs
    from libpillowfight_tpu_torch.ops.cuda import label as lb
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise
    from libpillowfight_tpu_torch.ops.unpaper.common import (dark_mask,
                                                             nonwhite_mask)
    tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

    b, h, w = words2.shape
    gray = words_to_gray(words2)  # canny's gray plane of the same pages
    dark, nonwhite = dark_mask(gray), nonwhite_mask(gray)
    seeds, _ = blackfilter_flood_inputs(gray)
    seeds_w, dark_w = fp.pack_rows_plain(seeds), fp.pack_rows_plain(dark)
    cert_w, nonwhite_w = noise.noise_cert_plain(nonwhite, 2, 5)
    taps = gaussian_taps(C.CANNY_GAUSSIAN_SIGMA, C.CANNY_GAUSSIAN_NB_STDDEV)
    tap_row = torch.tensor(taps, dtype=torch.float32,
                           device=gray.device).view(1, 1, 1, -1)
    sy, sx = tace.sample_coords(ACE_SEED, b, C.ACE_DEFAULT_NB_SAMPLES, h, w)
    sy, sx = sy.to(words2.device), sx.to(words2.device)
    planar, sval = tace.spray_inputs(words_to_pages(words2), sy, sx)
    slope, limit = C.ACE_DEFAULT_SLOPE, C.ACE_DEFAULT_LIMIT
    valid, links = swt2["valid"], swt2["links"]
    gray600 = words_to_gray(words600)
    seeds600, dark600 = blackfilter_flood_inputs(gray600)
    nonwhite600 = nonwhite_mask(gray600)
    dark600_w = fp.pack_rows_plain(dark600)
    h6, w6 = dark600.shape[1:]

    def exact(got, want):
        err = max_abs_err(got, want)
        return err, err == 0.0

    def spray_bar(got, want):
        err_n, err_i, top = spray_errors(got, want)
        ok = (err_n <= spray.ACE_SPRAY_RTOL * limit * top
              and err_i <= spray.ACE_SPRAY_RTOL * top)
        return max(err_n, err_i), ok

    def blur_library():
        # f32 convolutions: cuDNN would take TF32 by default
        r = len(taps) // 2
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            rows = F.conv2d(gray[:, None], tap_row, padding=(0, r))
            return F.conv2d(rows, tap_row.transpose(2, 3), padding=(r, 0))
        finally:
            torch.backends.cudnn.allow_tf32 = saved

    # name -> (kernel, plain, bar, inputs, f32 operations, one PyTorch
    # call for the same function or None, special-function results)
    n_spray = sy.shape[-1] * b * h * w  # pixel-samples
    cases = {
        "line_counts": (lambda: lc.line_counts_cuda(dark),
                        lambda: lc.line_counts_plain(dark), exact, [dark], 0,
                        lambda: (dark.sum(2), dark.sum(1))),
        "pack_rows": (lambda: fp.pack_rows_cuda(dark),
                      lambda: fp.pack_rows_plain(dark), exact, [dark], 0,
                      None),
        "unpack_rows": (lambda: fp.unpack_rows_cuda(dark_w, h),
                        lambda: fp.unpack_rows_plain(dark_w, h), exact,
                        [dark_w], 0, None),
        "flood_round": (
            lambda: fp.flood_packed_cuda(seeds_w, dark_w, h, w, leap=20),
            lambda: fp.flood_packed_plain(seeds_w, dark_w, h, w, leap=20),
            exact, [seeds_w, dark_w], 0, None),
        "noise_cert": (lambda: noise.noise_cert_cuda(nonwhite, 2, 5),
                       lambda: noise.noise_cert_plain(nonwhite, 2, 5), exact,
                       [nonwhite], 0, None),
        "noise_ball": (lambda: noise.noise_ball_cuda(nonwhite, 1),
                       lambda: noise.noise_ball_plain(nonwhite, 1), exact,
                       [nonwhite], 0, None),
        "gaussian_sep": (lambda: gs.gaussian_sep_cuda(gray, taps),
                         lambda: gs.gaussian_sep_plain(gray, taps), exact,
                         [gray], 4 * (2 * len(taps) - 1) * gray.numel(),
                         blur_library),
        "ace_spray": (
            lambda: spray.ace_spray_cuda(planar, sy, sx, sval, slope, limit),
            lambda: spray.ace_spray_plain(planar, sy, sx, sval, slope, limit),
            spray_bar, [planar, sy, sx, sval],
            2 * ACE_SLOTS_PER_PIXEL_SAMPLE * n_spray, None, n_spray),
        "label_links": (lambda: lb.label_links_cuda(valid, links),
                        lambda: lb.label_links_plain(valid, links), exact,
                        [valid, *links.values()], 0, None),
        "flood_sweep": (
            lambda: fs.flood_sweep_cuda(seeds600, dark600, leap=20),
            lambda: fs.flood_sweep_plain(seeds600, dark600, leap=20),
            exact, [seeds600, dark600], 0, None),
    }
    # the unpack's 17.4 MB of output at A4 x 2 fits in the 50 MB L2, so it
    # may end before its writes reach device memory: it is also timed at
    # A4 600 dpi x 2 (70 MB out), where its bound is held if its time at
    # A4 x 2 reads under the bound even with L2 evicted
    large = {"unpack_rows": (lambda: fp.unpack_rows_cuda(dark600_w, h6),
                             [dark600_w])}
    out = {}
    for name, (kernel, plain, bar, inputs, n_ops, library,
               *n_sfu) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = bar(got, want)
        if not ok:
            raise AssertionError(f"{name}: kernel differs from plain, "
                                 f"max |diff| {err}")
        outputs = got if isinstance(got, tuple) else (got,)
        split = three_way(kernel, DEVICE_FUNCTIONS[name], iters=50)
        out[name] = {
            "max_abs_err": err, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain, iters=2),
            **bound(nbytes(*inputs, *outputs), n_ops, *n_sfu),
            "library_ms": cuda_ms(library) if library else None,
            **{k: split[k] for k in ("kernel_ms", "other_device_ms",
                                     "host_ms")}}
        r = out[name]
        key = held_reading(r, kernel, name, f"A4 x {b}")
        held = [("ms", r), (key, r)]
        if name in large:
            fn600, inputs600 = large[name]
            r600 = {**bound(nbytes(*inputs600, fn600())),
                    "kernel_ms": kernel_time(
                        device_split(fn600, kernels=DEVICE_FUNCTIONS[name]),
                        DEVICE_FUNCTIONS[name])}
            key600 = held_reading(r600, fn600, name, f"A4 600 dpi x {b}")
            r["at_600dpi"] = r600
            log(f"kernel {name} at A4 600 dpi x {b}: {r600}")
            if r[key] < r["bound_ms"]:
                log(f"kernel {name}: {key} {r[key]} at A4 x {b} reads under "
                    f"its bound of {r['bound_ms']} ms (its output fits in "
                    f"L2); its bound is held at A4 600 dpi x {b}")
                held = [("ms", r), (key600, r600)]
        for what, rr in held:
            if rr[what] < rr["bound_ms"]:
                raise AssertionError(f"{name}: {what} {rr[what]} reads under "
                                     f"its bound of {rr['bound_ms']} ms")
        log(f"kernel {name}: max |diff| {err}; {r['ms']:.4f} ms vs plain "
            f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; one PyTorch call: "
            + (f"{r['library_ms']:.4f} ms" if library else "none")
            + (" (two F.conv2d, TF32 off)" if name == "gaussian_sep" else "")
            + f"; a call three ways: kernel {r['kernel_ms']:.5f} ms of "
            f"device time, the wrapper's other device operations "
            f"{r['other_device_ms']:.5f} ms, host {r['host_ms']:.5f} ms; "
            f"device ms by name {split['by_name']}")
        del got, want, outputs

    check_blur_cases(gray, blur_planes_rgb(words2), gray600)
    del gray600
    check_line_count_cases(dark, dark600)
    check_pack_cases(dark, dark600)
    check_unpack_cases(dark_w, dark600_w, h, h6)
    check_cert_cases(nonwhite, nonwhite600)
    check_ball_cases(nonwhite600)
    del nonwhite600, dark600_w

    # the noisefilter flood (leap 1, from certificates) too
    got = fp.flood_packed_cuda(cert_w, nonwhite_w, h, w, leap=1)
    want = fp.flood_packed_plain(cert_w, nonwhite_w, h, w, leap=1)
    if max_abs_err(got, want) != 0.0:
        raise AssertionError("flood_round at leap 1 differs from plain")
    log("kernel flood_round (leap 1, noisefilter inputs): bit-identical")
    time_packed_flood(seeds_w, dark_w, h, w, 20,
                      f"A4 x {b}, blackfilter inputs")
    time_packed_flood(cert_w, nonwhite_w, h, w, 1,
                      f"A4 x {b}, noisefilter inputs")
    check_flood_cases(dark.device)
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

    # the label kernel as label_components: the non-white plane, 8- and
    # 4-connected
    for what, links_c in (("8-connected", None),
                          ("4-connected", lb.mask_links(nonwhite, 4))):
        got = lb.label_links_cuda(nonwhite, links_c)
        want = lb.label_links_plain(nonwhite, links_c)
        if max_abs_err(got, want) != 0.0:
            raise AssertionError(f"label_links ({what}, non-white plane) "
                                 f"differs from plain")
        n_comp = int((got == torch.arange(h * w, device=got.device,
                                          dtype=torch.int32).view(1, h, w))
                     .sum())
        ms = cuda_ms(lambda: lb.label_links_cuda(nonwhite, links_c))
        log(f"kernel label_links as label_components ({what}, non-white "
            f"plane A4 x {b}): bit-identical, {n_comp} components, "
            f"{ms:.4f} ms")
        del got, want

    # random links on a random plane: links that leave the page or meet an
    # invalid pixel reach the kernel as they are, and must join nothing
    gen = torch.Generator().manual_seed(1)
    rvalid = (torch.rand((2, 1000, 700), generator=gen) < 0.45).to(dark.device)
    rlinks = {d: (torch.rand((2, 1000, 700), generator=gen) < 0.6)
              .to(dark.device) for d in lb.OFFSETS}
    if not torch.equal(lb.label_links_cuda(rvalid, rlinks),
                       lb.label_links_plain(rvalid, rlinks)):
        raise AssertionError("label_links on random links differs from plain")
    log("kernel label_links on a random plane with random links "
        "(2 x 1000 x 700): bit-identical")
    del rvalid, rlinks

    check_label_cases(dark.device)
    check_spray_errors(words2)
    check_flood4_and_compare(words2, gray)

    # the sweep flood against the packed flood, and at leap 1
    sweep = fs.flood_sweep_cuda(seeds600, dark600, leap=20)
    if not torch.equal(sweep, packed_flood(seeds600, dark600, 20)):
        raise AssertionError("flood_sweep differs from the packed flood at "
                             "600 dpi, leap 20")
    time_sweep_flood(seeds600, dark600, 20,
                     f"A4 600 dpi x {b}, blackfilter inputs")
    time_packed_flood(fp.pack_rows_cuda(seeds600), fp.pack_rows_cuda(dark600),
                      h6, w6, 20, f"A4 600 dpi x {b}, blackfilter inputs")
    log(f"flood at A4 600 dpi x {b}, leap 20 (blackfilter inputs, "
        f"{int(sweep.sum())} pixels reached): sweep flood "
        f"{out['flood_sweep']['ms']:.4f} ms, packed flood (pack and unpack "
        f"included) "
        f"{cuda_ms(lambda: packed_flood(seeds600, dark600, 20)):.4f} ms, "
        f"bit-identical")
    del sweep
    strong, weak = swt2["strong"], swt2["weak"]
    got = fs.flood_sweep_cuda(strong, weak, leap=1)
    if not (torch.equal(got, fs.flood_sweep_plain(strong, weak, leap=1))
            and torch.equal(got, packed_flood(strong, weak, 1))):
        raise AssertionError("flood_sweep at leap 1 (canny planes) differs "
                             "from plain or from the packed flood")
    log(f"kernel flood_sweep (leap 1, canny strong/weak A4 x {b}): "
        f"bit-identical to plain and to the packed flood")
    time_sweep_flood(strong, weak, 1, f"A4 x {b}, canny strong/weak")
    time_packed_flood(fp.pack_rows_cuda(strong), fp.pack_rows_cuda(weak), h,
                      w, 1, f"A4 x {b}, canny strong/weak")
    # random planes, where every row and column distance up to the leap
    # occurs; leap 70 takes 512-thread blocks, leap 300 the 1024-thread
    # kernel
    gen = torch.Generator().manual_seed(0)
    for shape, density, leaps in (((2, 1000, 700), 0.45, (1, 2, 3)),
                                  ((1, 700, 2100), 0.05, (3, 5, 20, 70)),
                                  ((1, 700, 2100), 1e-5, (300,))):
        plane = (torch.rand(shape, generator=gen) < density).to(dark.device)
        some = (torch.rand(shape, generator=gen)
                < (5e-4 if density > 1e-3 else 0.2)).to(dark.device) & plane
        for leap in leaps:
            want = fs.flood_sweep_plain(some, plane, leap=leap)
            if not (torch.equal(fs.flood_sweep_cuda(some, plane, leap=leap),
                                want)
                    and torch.equal(packed_flood(some, plane, leap), want)):
                raise AssertionError(f"a flood on a random {shape} plane at "
                                     f"leap {leap} differs from plain")
    log("kernels flood_sweep and flood_round on random planes (leap 1, 2, 3 "
        "at 45%; 3, 5, 20, 70 at 5%; 300 at 0.001%): bit-identical")
    return out


def _counters():
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import flood_sweep as fs
    from libpillowfight_tpu_torch.ops.cuda import gaussian as gs
    from libpillowfight_tpu_torch.ops.cuda import label as lb
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise
    return spray, fp, gs, lc, noise, lb, fs


def launch_counts() -> dict:
    spray, fp, gs, lc, noise, lb, fs = _counters()
    return {"line_counts": lc.launches, **fp.launches, **noise.launches,
            "gaussian_sep": gs.launches,
            **{f"gaussian_sep[{k}]": v for k, v in gs.instance_launches.items()},
            "ace_spray": spray.launches,
            "label_links": lb.launches, "flood_sweep": fs.launches}


def reset_launch_counts() -> None:
    spray, fp, gs, lc, noise, lb, fs = _counters()
    lc.launches = gs.launches = spray.launches = 0
    lb.launches = fs.launches = 0
    for d in (fp.launches, noise.launches, gs.instance_launches):
        for k in d:
            d[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Every wrapper takes its plain version, whatever the device: the
    dispatch test of each wrapper module answers False."""
    mods = _counters()
    saved = [m.use_kernel for m in mods]
    for m in mods:
        m.use_kernel = lambda *tensors: False
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.use_kernel = fn


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


def check_chain(out_gpu, words_cpu, spec, name: str) -> torch.Tensor:
    """Bit-identical to the plain chain on the CPU, and a real wipe.
    Returns the plain chain's output."""
    import libpillowfight_tpu_torch as pt

    t0 = time.perf_counter()
    out_cpu = pt.run_pipeline(words_cpu, spec)
    log(f"{name}: plain on the CPU ({tuple(words_cpu.shape)}) "
        f"{time.perf_counter() - t0:.1f} s")
    if not torch.equal(out_gpu.cpu(), out_cpu):
        n = int((out_gpu.cpu() != out_cpu).sum())
        raise AssertionError(f"{name} on the card differs from the plain "
                             f"chain on {n} pixels")
    changed = int((out_cpu != words_cpu).sum())
    if out_cpu.shape != words_cpu.shape or changed == 0:
        raise AssertionError(f"{name} output {tuple(out_cpu.shape)} "
                             f"wiped {changed} pixels")
    log(f"{name} {tuple(words_cpu.shape)}: bit-identical to the plain "
        f"chain ({changed} pixels wiped)")
    return out_cpu


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
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

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


def check_swt(out_gpu, words2, swt2: dict, spec, small) -> None:
    """The swt path (mode 0) against the same swt on plain versions on the
    card, against the stage functions' letter mask, and on the small page
    against swt on the CPU; then modes 1 and 2."""
    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.ops import swt as S

    n_letters, n_runs = swt2["n_letters"].tolist(), swt2["n_runs"].tolist()
    log(f"swt A4 x {CHECK_BATCH}: letters per page {n_letters} (cap "
        f"{swt2['max_letters']}), row runs {n_runs} (cap {swt2['max_runs']})")
    if min(n_letters) == 0:
        raise AssertionError("swt: a page with glyphs gave no letters")
    if (max(n_letters) > swt2["max_letters"]
            or max(n_runs) > swt2["max_runs"]):
        raise AssertionError("swt: a cap cut the letter pass short")
    if not torch.equal(out_gpu, swt2["out"]):
        raise AssertionError("swt through run_pipeline differs from the "
                             "stage functions' output")
    t0 = time.perf_counter()
    with plain_versions():
        want = pt.run_pipeline(words2, spec)
    torch.cuda.synchronize()
    if not torch.equal(out_gpu, want):
        n = int((out_gpu != want).sum())
        raise AssertionError(f"swt with the kernels differs from swt with "
                             f"their plain versions on {n} pixels")
    log(f"swt A4 x {CHECK_BATCH}: bit-identical to swt with every kernel's "
        f"plain version on the card ({time.perf_counter() - t0:.1f} s), "
        f"{int(swt2['letter'].sum())} letter pixels")
    del want

    got = (pt.swt(small) & 0xFF) == 0
    t0 = time.perf_counter()
    ref = (pt.swt(small.cpu()) & 0xFF) == 0
    iou = float((got.cpu() & ref).sum()) / max(float((got.cpu() | ref).sum()),
                                               1.0)
    log(f"swt small page {tuple(small.shape[1:])}: letter-mask IoU "
        f"{iou:.6f} against swt on the CPU ({time.perf_counter() - t0:.1f} "
        f"s, {int(ref.sum())} letter pixels; bar {SWT_IOU_BAR})")
    if int(ref.sum()) == 0 or iou < SWT_IOU_BAR:
        raise AssertionError(f"swt small page: IoU {iou} below {SWT_IOU_BAR}")

    alpha = words2 & -0x1000000
    letter = swt2["letter"]
    g8 = torch.round(swt2["gray"]).clamp(0, 255).to(torch.int32)
    out1 = pt.run_pipeline(words2, pt.normalize_spec(
        [("swt", {"output_type": 1})]))
    if not torch.equal(out1, S._gray_word(torch.where(letter, g8, 255),
                                          alpha)):
        raise AssertionError("swt mode 1: not the page's gray on the "
                             "letters and white elsewhere")
    out2 = pt.run_pipeline(words2, pt.normalize_spec(
        [("swt", {"output_type": 2})]))
    on_box = S._boxes_on_mask(swt2["boxes"], swt2["boxes_ok"],
                              *words2.shape[1:])
    changed = out2 != words2
    if not (torch.equal(out2, torch.where(on_box, alpha | 0xFF, words2))
            and bool((changed <= on_box).all()) and int(changed.sum()) > 0):
        raise AssertionError("swt mode 2: a changed pixel is not red on a "
                             "box perimeter")
    log(f"swt modes 1 and 2 A4 x {CHECK_BATCH}: shape, alpha and letters "
        f"hold; {int(swt2['boxes_ok'].sum())} boxes, {int(changed.sum())} "
        f"pixels drawn, all red on a box perimeter")


# -- the card's A4 outputs against the C oracle -----------------------------

# the bars of the reference's own oracle tests (tests/test_golden_oracle.py)
ORACLE_LSB_BAR = 1          # gaussian, sobel, ace with injected samples
UNPAPER_IOU_BAR = 0.99      # wiped-region IoU of each unpaper filter
UNPAPER_DIFFER_BAR = 0.01   # share of pixels that may differ
ORACLE_ACE_SAMPLES = 16     # at 100 the oracle takes ~26 s at A4


def check_oracle(total: dict, dev, card: str) -> None:
    """gaussian, sobel, canny, the six unpaper filters, swt (mode 0, on a
    `bar_pages` page; on a `text_pages` page a reading only) and ace (16
    shared samples injected into both) on one A4 page on the card, each
    call counted, against the C oracle (`utils.oracle`) at the bars of the
    reference's oracle tests; a miss raises."""
    import numpy as np

    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.ops import ace_with_samples
    from libpillowfight_tpu_torch.utils import oracle
    from libpillowfight_tpu_torch.utils.pages import (bar_pages,
                                                      synthetic_pages,
                                                      text_pages)

    t0 = time.perf_counter()
    oracle.load()
    log(f"oracle: built (make -C oracle) and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    page = synthetic_pages(1, A4_H, A4_W)[0]
    x = torch.from_numpy(page[None]).to(dev)

    def on_card(name: str, fn, expect: list):
        out, counts = counted(fn, f"oracle phase: {name}", expect)
        for k in total:
            total[k] += counts[k]
        return out[0].cpu().numpy()

    def reference(name: str, *args):
        t = time.perf_counter()
        out = getattr(oracle, name)(*args)
        return out, time.perf_counter() - t

    def lsb(a, b) -> int:
        return int(np.abs(a[..., :3].astype(np.int32)
                          - b[..., :3].astype(np.int32)).max())

    for name in ("gaussian", "sobel"):
        got = on_card(name, lambda: getattr(pt, name)(x),
                      FACADE_KERNELS[name])
        want, dt = reference(name, page)
        d = lsb(got, want)
        log(f"oracle {name} A4: max {d} LSB (bar {ORACLE_LSB_BAR}; oracle "
            f"{dt:.1f} s) on {card}")
        if d > ORACLE_LSB_BAR:
            raise AssertionError(f"{name}: {d} LSB from the oracle")

    got = on_card("canny", lambda: pt.canny(x), FACADE_KERNELS["canny"])
    want, dt = reference("canny", page)
    edges = want[..., 0] > 0
    differ = int(((got[..., 0] > 0) != edges).sum())
    bar = max(CANNY_BAR * int(edges.sum()), 2)
    log(f"oracle canny A4: {differ} of {int(edges.sum())} edge pixels differ "
        f"(bar {bar:.1f}; oracle {dt:.1f} s) on {card}")
    if int(edges.sum()) == 0 or differ > bar:
        raise AssertionError(f"canny: {differ} edge pixels differ from the "
                             f"oracle")

    for name in ("unpaper_blackfilter", "unpaper_noisefilter",
                 "unpaper_blurfilter", "unpaper_grayfilter", "unpaper_border",
                 "unpaper_masks"):
        got = on_card(name, lambda: getattr(pt, name)(x),
                      FACADE_KERNELS[name])
        want, dt = reference(name.removeprefix("unpaper_"), page)
        wa = (got[..., :3] != page[..., :3]).any(-1)
        wb = (want[..., :3] != page[..., :3]).any(-1)
        union = int((wa | wb).sum())
        iou = float((wa & wb).sum()) / union if union else 1.0
        n, _ = pt.compare(torch.from_numpy(got)[None],
                          torch.from_numpy(want)[None])
        frac = int(n[0]) / (A4_H * A4_W)
        log(f"oracle {name} A4: wiped-region IoU {iou:.6f} (bar "
            f"{UNPAPER_IOU_BAR}), {int(n[0])} pixels differ = {frac:.4%} "
            f"(bar {UNPAPER_DIFFER_BAR:.0%}), {int(wb.sum())} wiped by the "
            f"oracle ({dt:.1f} s) on {card}")
        if iou < UNPAPER_IOU_BAR or frac >= UNPAPER_DIFFER_BAR:
            raise AssertionError(f"{name}: IoU {iou}, {frac:.4%} of pixels "
                                 f"differ from the oracle")

    def swt_iou(tpage, what: str) -> float:
        got = on_card(f"swt, {what}",
                      lambda: pt.swt(torch.from_numpy(tpage[None]).to(dev)),
                      FACADE_KERNELS["swt"])
        want, dt = reference("swt", tpage, 0)
        gm, wm = (got[..., :3] != 255).any(-1), (want[..., :3] != 255).any(-1)
        iou = float((gm & wm).sum()) / max(float((gm | wm).sum()), 1.0)
        log(f"oracle swt (mode 0) A4 {what}: letter-mask IoU {iou:.6f} "
            f"({int(wm.sum())} letter pixels by the oracle, {int(gm.sum())} "
            f"on the card; oracle {dt:.1f} s) on {card}")
        if int(wm.sum()) == 0:
            raise AssertionError(f"swt: the oracle found no letters, {what}")
        return iou

    iou = swt_iou(bar_pages(1, A4_H, A4_W)[0], "bar letters")
    if iou < SWT_IOU_BAR:
        raise AssertionError(f"swt: letter-mask IoU {iou} against the oracle "
                             f"(bar {SWT_IOU_BAR})")
    # The reference's own swt reads ~0.9 against the oracle on the 5-px
    # strokes of text_pages (ROADMAP.md queue 3); the card's swt there is
    # held bit-identical to its plain version in phase 5. A reading only.
    swt_iou(text_pages(1, A4_H, A4_W)[0], "text page (5-px strokes)")

    rng = np.random.default_rng(ACE_SEED)
    sy = rng.integers(0, A4_H, ORACLE_ACE_SAMPLES).astype(np.int32)
    sx = rng.integers(0, A4_W, ORACLE_ACE_SAMPLES).astype(np.int32)
    got = on_card("ace", lambda: ace_with_samples(
        x, torch.from_numpy(sy)[None].to(dev),
        torch.from_numpy(sx)[None].to(dev), 10.0, 1000.0), ["ace_spray"])
    want, dt = reference("ace_samples", page, sy, sx, 10.0, 1000.0)
    d = lsb(got, want)
    log(f"oracle ace A4, {ORACLE_ACE_SAMPLES} shared samples injected into "
        f"both: max {d} LSB (bar {ORACLE_LSB_BAR}; oracle {dt:.1f} s) on "
        f"{card}")
    if d > ORACLE_LSB_BAR:
        raise AssertionError(f"ace: {d} LSB from the oracle")


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
    mp = batches[0].numel() / 1e6
    log(f"{name} {tuple(batches[0].shape)}: median {ms:.2f} ms over "
        f"{TIME_ITERS} (all: {', '.join(f'{t:.2f}' for t in times)}); "
        f"{mp / (ms / 1e3):.2f} MP/s on {card}")
    return ms


def idle_share(fn, x, name: str, wall_ms: float) -> None:
    """Device time of the kernels of one profiled run, against the
    path's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    # kernel, memcpy and memset rows only: an operator's row repeats the
    # device time of the kernels it launched
    busy_us = sum(getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        log(f"{name}: device idle share not measured (the profiler shows "
            f"no device time)")
        return
    log(f"{name}: {busy_us / 1e3:.2f} ms of kernel time in one profiled "
        f"run against {wall_ms:.2f} ms unprofiled: device idle share "
        f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.1%}")


# -- the façade, the runner and config 5 ------------------------------------

# The kernels each façade call launches on the card at A4 300 dpi; a
# function listed with none must launch none. `ace` is the façade's
# default mode, "rolled" (plain torch, as in the reference).
FACADE_KERNELS = {
    "unpaper_blackfilter": ["pack_rows", "flood_round", "unpack_rows"],
    "unpaper_noisefilter": ["noise_cert", "flood_round", "unpack_rows"],
    "unpaper_blurfilter": [],
    "unpaper_masks": ["line_counts"],
    "unpaper_grayfilter": [],
    "unpaper_border": ["line_counts"],
    "gaussian": ["gaussian_sep", "gaussian_sep[hw10]"],
    "sobel": [],
    "canny": ["gaussian_sep", "pack_rows", "flood_round", "unpack_rows"],
    "swt": ["gaussian_sep", "pack_rows", "flood_round", "unpack_rows",
            "label_links"],
    "ace": [],
    "compare": [],
}
# held to the CPU on a SWT_SMALL page: the CPU takes too long at A4
SMALL_ON_CPU = ("swt", "ace")
CHAIN_KERNELS = ["line_counts", "pack_rows", "unpack_rows", "flood_round",
                 "noise_cert"]
RUNNER_CHUNK, RUNNER_PAGES, CORPUS_FILES = 16, 64, 16
CONFIG5_PAGES = 128


def corpus_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chiprun_out", "smoke_corpus")


def write_corpus(pages, name: str) -> list:
    """Each page as a binary PPM, written by the port's `io.write_ppm`."""
    import os

    from libpillowfight_tpu_torch import io as pio

    d = os.path.join(corpus_dir(), name)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, page in enumerate(pages):
        paths.append(os.path.join(d, f"page_{i:03d}.ppm"))
        pio.write_ppm(paths[-1], page)
    return paths


def facade_call(name: str, pages: list, kw: dict, use_pil: bool):
    """One façade call on uint8 RGBA numpy pages (two for compare):
    through `pillowfight_torch` on PIL images where PIL imports, else
    through the façade's private numpy-in, numpy-out function. Returns
    numpy RGBA, or (count, diff) for compare."""
    import numpy as np

    from libpillowfight_tpu_torch import compat

    if use_pil:
        import pillowfight_torch

        from libpillowfight_tpu_torch.core.bitmap import to_pil

        out = getattr(pillowfight_torch, name)(*map(to_pil, pages), **kw)
        return (out[0], np.asarray(out[1])) if name == "compare" \
            else np.asarray(out)
    if name.startswith("unpaper_"):
        return compat._unpaper_rgba(name, *pages, **kw)
    return getattr(compat, f"_{name}_rgba")(*pages, **kw)


def facade_parity(name: str, got, want) -> str:
    """Hold a façade result to another at the ROADMAP's bar for it;
    returns what was found, raises past the bar."""
    import numpy as np

    if name == "compare":
        if got[0] != want[0] or not np.array_equal(got[1], want[1]):
            raise AssertionError(f"compare: {got[0]} against {want[0]} "
                                 f"differing pixels, or another diff page")
        return f"bit-identical ({got[0]} differing pixels)"
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} against "
                             f"{want.shape} {want.dtype}")
    if name.startswith("unpaper_"):
        n = int((got != want).sum())
        if n:
            raise AssertionError(f"{name}: {n} bytes differ")
        return "bit-identical"
    if name in ("gaussian", "sobel", "ace"):
        lsb = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
        if lsb > 1:
            raise AssertionError(f"{name}: {lsb} LSB apart")
        return f"max {lsb} LSB"
    if name == "canny":
        edges = int((want[..., 0] > 0).sum())
        differ = int((got[..., 0] != want[..., 0]).sum())
        if edges == 0 or differ > CANNY_BAR * edges:
            raise AssertionError(f"canny: {differ} of {edges} edge pixels "
                                 f"differ")
        return f"{differ} of {edges} edge pixels differ"
    a, b = got[..., 0] != 255, want[..., 0] != 255  # swt's letters
    iou = float((a & b).sum()) / max(float((a | b).sum()), 1.0)
    if int(b.sum()) == 0 or iou < SWT_IOU_BAR:
        raise AssertionError(f"swt: letter-mask IoU {iou} ({int(b.sum())} "
                             f"letter pixels)")
    return f"letter-mask IoU {iou:.6f} ({int(b.sum())} letter pixels)"


def check_facade(total: dict) -> None:
    """The façade's 13 functions on one A4 page on the card, each call
    counted and held to the same call with device="cpu"; ace in mode
    "shared" (the spray kernel) and the blackfilter at A4 600 dpi (the
    sweep flood) once each."""
    from libpillowfight_tpu_torch.utils.pages import (synthetic_pages,
                                                      text_pages)

    try:
        import PIL.Image  # noqa: F401
        use_pil = True
        log("façade: through pillowfight_torch on PIL images")
    except ImportError:
        use_pil = False
        log("façade: PIL does not import here, so through the façade's "
            "private numpy-in, numpy-out functions (compat._<name>_rgba)")
    page = text_pages(1, A4_H, A4_W)[0]
    other = page.copy()
    other[A4_H // 3: A4_H // 2, A4_W // 4: A4_W // 2, :3] = 128
    small = text_pages(1, *SWT_SMALL)[0]
    cpu = {"device": "cpu"}
    runs = [(name, {}, FACADE_KERNELS[name]) for name in FACADE_KERNELS]
    runs.append(("ace", {"mode": "shared"}, ["ace_spray"]))
    for name, kw, expect in runs:
        pages = [page, other] if name == "compare" else [page]
        label = f"façade {name}" + (f" {kw}" if kw else "")
        t0 = time.perf_counter()
        got, counts = counted(lambda: facade_call(name, pages, kw, use_pil),
                              label, expect)
        card_s = time.perf_counter() - t0
        launched = [k for k in KERNELS if counts[k]]
        if not expect and launched:
            raise AssertionError(f"{label} launched {launched}, expected "
                                 f"none")
        for k in total:
            total[k] += counts[k]
        t0 = time.perf_counter()
        if name in SMALL_ON_CPU:
            where = f"SWT_SMALL {SWT_SMALL}"
            note = facade_parity(
                name, facade_call(name, [small], kw, use_pil),
                facade_call(name, [small], {**kw, **cpu}, use_pil))
        else:
            where = "A4"
            note = facade_parity(name, got, facade_call(
                name, pages, {**kw, **cpu}, use_pil))
        if kw.get("mode") == "shared":
            with plain_versions():
                plain = facade_call(name, pages, kw, use_pil)
            note += ("; A4 against its plain versions on the card: "
                     + facade_parity(name, got, plain))
        log(f"{label}: card {card_s:.2f} s, launched {launched or 'none'}; "
            f"against device='cpu' at {where} ({time.perf_counter() - t0:.1f}"
            f" s): {note}")
    del got, page, other
    page600 = synthetic_pages(1, A4_600_H, A4_600_W)[0]
    got, counts = counted(lambda: facade_call("unpaper_blackfilter",
                                              [page600], {}, use_pil),
                          "façade unpaper_blackfilter, A4 600 dpi",
                          ["flood_sweep"])
    for k in total:
        total[k] += counts[k]
    t0 = time.perf_counter()
    note = facade_parity("unpaper_blackfilter", got, facade_call(
        "unpaper_blackfilter", [page600], cpu, use_pil))
    log(f"façade unpaper_blackfilter, A4 600 dpi: launched "
        f"{[k for k in KERNELS if counts[k]]}; against device='cpu' "
        f"({time.perf_counter() - t0:.1f} s): {note}")


class TimedSource:
    """A runner's source that records how long each call took (the time
    the runner waited on it) and when the first call began."""

    def __init__(self, src):
        self.src = src
        self.waits = []
        self.t_first = None

    def __call__(self, idx):
        t0 = time.perf_counter()
        if self.t_first is None:
            self.t_first = t0
        out = self.src(idx)
        self.waits.append(time.perf_counter() - t0)
        return out

    def summary(self) -> str:
        return (f"{sum(self.waits):.3f} s waiting on the source ({len(self.waits)}"
                f" calls: the first, decoded without prefetch, "
                f"{self.waits[0]:.3f} s; the others {sum(self.waits[1:]):.3f} s)")


class PageCheck:
    """A sink that holds each delivered page to the expected output of
    its file (`want[j % len(want)]`), counts deliveries and records the
    time spent in it and when it last returned."""

    def __init__(self, want):
        from collections import Counter

        self.want = want
        self.seen = Counter()
        self.bad = []
        self.t_last = None
        self.seconds = 0.0

    def __call__(self, idx, out) -> None:
        import numpy as np

        t0 = time.perf_counter()
        for i, j in enumerate(idx):
            self.seen[int(j)] += 1
            want = self.want[int(j) % len(self.want)]
            # compared as 64-bit words: half the time of bytes
            if out[i].shape != want.shape or not np.array_equal(
                    out[i].reshape(-1).view(np.uint64),
                    want.reshape(-1).view(np.uint64)):
                self.bad.append(int(j))
        self.t_last = time.perf_counter()
        self.seconds += self.t_last - t0

    def expect_once(self, n: int, what: str) -> None:
        twice = sorted(j for j, c in self.seen.items() if c > 1)
        if self.bad or twice or sorted(self.seen) != list(range(n)):
            raise AssertionError(
                f"{what}: pages differing from run_pipeline {self.bad[:8]}, "
                f"delivered twice {twice[:8]}, {len(self.seen)} of {n} "
                f"delivered")


def check_runner(total: dict, dev) -> None:
    """DOCUMENT_CLEANUP through `io.ImagePageSource` -> `BatchRunner` on
    PPM files: bit-identical to run_pipeline on the card; then killed at
    the third chunk by its source and resumed from the manifest."""
    import os

    import numpy as np

    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch import io as pio
    from libpillowfight_tpu_torch.parallel import BatchRunner
    from libpillowfight_tpu_torch.utils.pages import synthetic_pages

    spec = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
    pages = np.concatenate([synthetic_pages(1, A4_H, A4_W, seed=s)
                            for s in range(CORPUS_FILES)])
    paths = write_corpus(pages, "cleanup")
    log(f"runner: {CORPUS_FILES} distinct A4 pages written as PPM "
        f"(io codec: {'native libpfio' if pio.available() else 'numpy'})")
    want = pt.run_pipeline(torch.from_numpy(pages).to(dev), spec).cpu().numpy()
    cycle = [paths[j % CORPUS_FILES] for j in range(RUNNER_PAGES)]

    def run(source, sink, manifest=None):
        return BatchRunner(spec, chunk_size=RUNNER_CHUNK,
                           manifest_path=manifest).run(RUNNER_PAGES, source,
                                                       sink)

    check = PageCheck(want)
    with pio.ImagePageSource(cycle, shape=(A4_H, A4_W)) as src:
        source = TimedSource(src)
        m, counts = counted(lambda: run(source, check),
                            "runner DOCUMENT_CLEANUP", CHAIN_KERNELS)
        failed = src.failed
    for k in total:
        total[k] += counts[k]
    check.expect_once(RUNNER_PAGES, "runner")
    if failed or m.pages != RUNNER_PAGES:
        raise AssertionError(f"runner: {failed} pages failed to decode, "
                             f"{m.pages} processed")
    log(f"runner DOCUMENT_CLEANUP, {RUNNER_PAGES} A4 pages from "
        f"{CORPUS_FILES} PPM files, chunk {RUNNER_CHUNK}: every page "
        f"delivered once, bit-identical to run_pipeline on the card; "
        f"{json.dumps(m.to_dict())}; {source.summary()}, {check.seconds:.3f}"
        f" s in the checking sink")

    manifest = os.path.join(corpus_dir(), "cleanup.manifest")
    check = PageCheck(want)
    with pio.ImagePageSource(cycle, shape=(A4_H, A4_W)) as src:
        def dying(idx):
            if idx[0] == 2 * RUNNER_CHUNK:
                raise ValueError("source killed at the third chunk")
            return src(idx)

        try:
            run(dying, check, manifest)
        except ValueError:
            pass
        else:
            raise AssertionError("runner: the killed run did not raise")
        first = len(check.seen)
        m2 = run(src, check, manifest)
    check.expect_once(RUNNER_PAGES, "runner, resumed")
    if m2.pages != RUNNER_PAGES - first:
        raise AssertionError(f"runner, resumed: {m2.pages} pages processed "
                             f"after {first}")
    log(f"runner killed at chunk 3 by its source after {first} pages were "
        f"delivered, resumed from the manifest: {m2.pages} more, every page "
        f"delivered once, bit-identical to run_pipeline")


def config5(total: dict, dev, card: str) -> None:
    """Config 5 (BASELINE.json configs[4]): DOCUMENT_CLEANUP then swt over
    CONFIG5_PAGES A4 pages, read from CORPUS_FILES distinct `text_pages`
    PPM files through `io.ImagePageSource` -> `BatchRunner`. Wall clock
    from the first source call to the last sink, decode and both copies
    in; the files were just written, so they sit in the page cache and
    no disk read is in the number. Then one chunk again under the
    profiler, for the device's idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch import io as pio
    from libpillowfight_tpu_torch.parallel import BatchRunner
    from libpillowfight_tpu_torch.utils.pages import text_pages

    spec = pt.normalize_spec(pt.DOCUMENT_CLEANUP + (("swt", {}),))
    pages = np.concatenate([text_pages(1, A4_H, A4_W, seed=s)
                            for s in range(CORPUS_FILES)])
    paths = write_corpus(pages, "text")
    want = pt.run_pipeline(torch.from_numpy(pages).to(dev), spec).cpu().numpy()
    del pages
    cycle = [paths[j % CORPUS_FILES] for j in range(CONFIG5_PAGES)]
    check = PageCheck(want)
    with pio.ImagePageSource(cycle, shape=(A4_H, A4_W)) as src:
        source = TimedSource(src)
        runner = BatchRunner(spec, chunk_size=RUNNER_CHUNK)
        m, counts = counted(lambda: runner.run(CONFIG5_PAGES, source, check),
                            "config 5", CHAIN_KERNELS + ["gaussian_sep",
                                                         "label_links"])
        failed = src.failed
    for k in total:
        total[k] += counts[k]
    check.expect_once(CONFIG5_PAGES, "config 5")
    if failed:
        raise AssertionError(f"config 5: {failed} pages failed to decode")
    wall = check.t_last - source.t_first
    mp = CONFIG5_PAGES * A4_H * A4_W / 1e6
    log(f"config 5 (DOCUMENT_CLEANUP + swt, {CONFIG5_PAGES} A4 pages from "
        f"{CORPUS_FILES} PPM files in the page cache, chunk {RUNNER_CHUNK}, "
        f"one card): {wall:.3f} s wall clock from the first source call to "
        f"the last sink, {CONFIG5_PAGES / wall:.3f} pages/s, "
        f"{mp / wall:.2f} MP/s; {source.summary()}; {check.seconds:.3f} s in "
        f"the sink, which holds every page to run_pipeline on the card "
        f"(bit-identical): less that time {CONFIG5_PAGES / (wall - check.seconds):.3f}"
        f" pages/s, {mp / (wall - check.seconds):.2f} MP/s; chunks (s): "
        f"{', '.join(f'{t:.3f}' for t in m.chunk_seconds)}; "
        f"{json.dumps(m.to_dict())}; on {card}")
    chunk_ms = wall / (CONFIG5_PAGES / RUNNER_CHUNK) * 1e3
    with pio.ImagePageSource(paths, shape=(A4_H, A4_W)) as src:
        runner = BatchRunner(spec, chunk_size=RUNNER_CHUNK)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.run(RUNNER_CHUNK, src)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        log("config 5: device idle share not measured (the profiler shows "
            "no device time)")
        return
    log(f"config 5: one profiled chunk ({RUNNER_CHUNK} pages, its source "
        f"decoded without prefetch): {busy_us / 1e3:.2f} ms of device time "
        f"(kernels and copies) in {profiled_ms:.2f} ms profiled; against the "
        f"unprofiled run's {chunk_ms:.2f} ms a chunk: device idle share "
        f"{max(0.0, 1 - busy_us / 1e3 / chunk_ms):.1%}")


# -- the measurement tools ---------------------------------------------------

# the kernels of the rows-sharded chain, by the flood's route
SHARDED_PACKED = ["line_counts", "pack_rows", "flood_round", "unpack_rows",
                  "noise_cert"]
SHARDED_SWEEP = ["line_counts", "flood_sweep", "flood_round", "unpack_rows",
                 "noise_cert"]


def check_rows_sharded(total: dict, dev, card: str) -> None:
    """Phase 7b: the distribution layer on the card, each call counted:
    the dry run on cuda:0 x 4 (and over every card where there are
    several), the rows-sharded chain bit-identical to the unsharded chain
    at A4 x 4 on (2, 2) shards and at A4 600 dpi x 2 on (1, 2) (the sweep
    flood) and (1, 4) (the packed flood), `sharded_stencil` of the blur
    on A4 gray planes against the unsharded blur, and the sharded chain
    timed beside the unsharded one at A4 x 16 on (1, 2) shards of cuda:0."""
    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.core.bitmap import words_to_gray
    from libpillowfight_tpu_torch.ops.gaussian import gaussian_on_matrix
    from libpillowfight_tpu_torch.parallel import (dryrun_multichip,
                                                   make_mesh, shard_pages,
                                                   sharded_stencil, spatial)
    from libpillowfight_tpu_torch.utils.pages import (snake_pages,
                                                      synthetic_pages)

    t0 = time.perf_counter()
    cleanup = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
    n_cards = torch.cuda.device_count()

    def run(fn, name, expect):
        out, counts = counted(fn, name, expect)
        for k in total:
            total[k] += counts[k]
        return out, counts

    def one_card(pages_axis, rows):
        n = pages_axis * rows
        return make_mesh(n, rows=rows, devices=[dev] * n)

    runs = [(4, ["cuda:0"] * 4, "cuda:0 x 4")]
    if n_cards > 1:
        runs.append((n_cards, None, f"{n_cards} cards"))
    for n, devs, what in runs:
        out, _ = run(lambda: dryrun_multichip(n, devices=devs),
                     f"dryrun_multichip({n}) on {what}",
                     ["line_counts", "pack_rows", "flood_round",
                      "unpack_rows", "noise_cert", "gaussian_sep"])
        log(f"dryrun_multichip({n}) on {what}: the three checks held; "
            f"flood exchange rounds {out['flood_rounds']}, stencil max "
            f"abs err {out['stencil_max_abs_err']}")

    a4, a4_600 = (A4_H, A4_W), (A4_600_H, A4_600_W)
    cases = [("A4 x 4", synthetic_pages(4, *a4), one_card(2, 2),
              SHARDED_PACKED, "pack_rows")]
    for rows, expect, route in ((2, SHARDED_SWEEP, "flood_sweep"),
                                (4, SHARDED_PACKED, "pack_rows")):
        cases.append(("A4 600 dpi x 2", synthetic_pages(2, *a4_600),
                      one_card(1, rows), expect, route))
    # the snake's flood crosses every boundary once an arm: many rounds
    cases += [("snake A4 x 2", snake_pages(2, *a4), one_card(1, 4),
               SHARDED_PACKED, "pack_rows"),
              ("snake A4 600 dpi x 1", snake_pages(1, *a4_600),
               one_card(1, 2), SHARDED_SWEEP, "flood_sweep")]
    if n_cards > 1:
        cases.append(("A4 x 4", synthetic_pages(4, *a4),
                      make_mesh(n_cards, rows=n_cards), SHARDED_PACKED,
                      "pack_rows"))
    for name, pages, mesh, expect, route in cases:
        words = words_on(pages, dev)
        want = pt.run_pipeline(words, cleanup)
        x = shard_pages(words, mesh)
        grid = f"{tuple(mesh.devices.shape)} on " + ", ".join(
            sorted({str(d) for d in mesh.devices.flat}))
        got, counts = run(lambda: pt.run_pipeline(x, cleanup).gather(dev),
                          f"rows-sharded chain {name} {grid}", expect)
        other = {"flood_sweep": "pack_rows", "pack_rows": "flood_sweep"}[route]
        if counts[other]:
            raise AssertionError(f"rows-sharded chain {name} {grid}: "
                                 f"{other} launched beside {route}")
        if not torch.equal(got, want):
            raise AssertionError(
                f"rows-sharded chain {name} {grid} differs from the "
                f"unsharded chain on {int((got != want).sum())} pixels")
        if name.startswith("snake") and min(spatial.flood_rounds) <= \
                mesh.devices.shape[1]:
            raise AssertionError(f"{name} {grid}: exchange rounds "
                                 f"{spatial.flood_rounds}, expected more "
                                 f"than the row shards")
        log(f"rows-sharded chain {name} {grid}: bit-identical to the "
            f"unsharded chain on the card; row shards "
            f"{[b - a for a, b in zip(x.row_offsets, x.row_offsets[1:])]}, "
            f"the blackfilter's "
            f"flood by {route}, exchange rounds a page column "
            f"{spatial.flood_rounds}")
        del words, want, x, got, pages

    gray = words_to_gray(words_on(synthetic_pages(2, A4_H, A4_W), dev))
    mesh = one_card(1, 4)
    got, _ = run(lambda: sharded_stencil(
        lambda t: gaussian_on_matrix(t, 2.0, 5), mesh, 10)(gray).gather(dev),
        "sharded_stencil(gaussian) A4 x 2 on (1, 4)",
        ["gaussian_sep", "gaussian_sep[hw10]"])
    want = gaussian_on_matrix(gray, 2.0, 5)
    err = float((got - want).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"sharded_stencil off the unsharded blur by "
                             f"{err}")
    log(f"sharded_stencil(gaussian sigma 2, halo 10) A4 x 2 gray on (1, 4): "
        f"{'bit-identical to' if torch.equal(got, want) else 'not bit-identical to'} "
        f"the unsharded blur, max abs err {err}")
    del gray, got, want

    batches = [words_on(synthetic_pages(TIME_BATCH, A4_H, A4_W, seed=s), dev)
               for s in (0, 1)]
    mesh = one_card(1, 2)
    plain_ms = time_path(lambda b: pt.run_pipeline(b, cleanup), batches,
                         "chain, unsharded", card)
    ms = time_path(lambda b: pt.run_pipeline(shard_pages(b, mesh),
                                             cleanup).gather(dev),
                   batches, "chain, rows-sharded on (1, 2) shards of cuda:0 "
                   "(shard_pages and gather included)", card)
    log(f"rows-sharded chain A4 x {TIME_BATCH} on (1, 2) shards of one card: "
        f"{ms:.2f} ms beside {plain_ms:.2f} ms unsharded, "
        f"{ms / plain_ms:.2f}x (a reading: one card does both shards' work, "
        f"the halos and the exchange rounds) on {card}")
    if n_cards == 1:
        log("one card: no cross-card copy was exercised (every shard on "
            "cuda:0)")
    log(f"phase 7b: {time.perf_counter() - t0:.1f} s")


def check_tools(total: dict, plain_page: torch.Tensor) -> None:
    """Phase 8: `bench_torch.run` once at full size, its checked page held
    to phase 5's plain chain (seed 0, page 0), then the profile tools at
    their default sizes (the chain and the blackfilter also at A4 600 dpi
    x 2); each record printed, each launch counted, every time a stage
    reads above 0. The records go to chiprun_out/smoke_tools_torch.json."""
    import bench_torch
    from libpillowfight_tpu_torch.tools import (
        profile_blackfilter, profile_chain, profile_chain_parts,
        profile_filters, profile_flood, timing)

    at600 = dict(b=2, h=A4_600_H, w=A4_600_W)
    packed = ["pack_rows", "flood_round", "unpack_rows"]
    runs = {  # name -> (the run, the kernels it must launch)
        "bench_torch": (lambda: bench_torch.run(plain=plain_page),
                        CHAIN_KERNELS),
        "profile_chain": (profile_chain.measure, CHAIN_KERNELS),
        "profile_chain at 600 dpi": (
            lambda: profile_chain.measure(**at600),
            ["line_counts", "noise_cert", "flood_sweep"]),
        "profile_chain_parts": (profile_chain_parts.measure,
                                packed + ["noise_cert"]),
        "profile_blackfilter": (profile_blackfilter.measure,
                                packed + ["flood_sweep"]),
        "profile_blackfilter at 600 dpi": (
            lambda: profile_blackfilter.measure(**at600), ["flood_sweep"]),
        "profile_flood": (profile_flood.measure, packed + ["flood_sweep"]),
        "profile_filters": (profile_filters.measure,
                            packed + ["gaussian_sep", "noise_cert",
                                      "line_counts", "label_links",
                                      "ace_spray"]),
    }
    records = {}
    for name, (fn, kernels) in runs.items():
        t0 = time.perf_counter()
        rec, counts = counted(fn, name, kernels)
        for k in total:
            total[k] += counts[k]
        if name == "bench_torch":
            times = {k: rec[k] for k in ("value", "vs_baseline", "ms_min",
                                         "ms_max")}
        else:
            times = {f"{key} {k}": v for key in ("ms", "device_ms")
                     for k, v in rec.get(key, {}).items()}
        bad = {k: v for k, v in times.items()
               if not isinstance(v, float) or v <= 0}
        if bad:
            raise AssertionError(f"{name}: times not above 0: {bad}")
        log(f"{name} ({time.perf_counter() - t0:.1f} s): {json.dumps(rec)}")
        records[name] = rec
    log(f"records: {timing.write('smoke_tools', records)}")


def load_tree(root: str, name: str):
    """The package of another tree of this repository, loaded beside this
    one under the module name `name` (its relative imports stay inside
    it, and it builds its own kernels from its own sources)."""
    import importlib.util
    from pathlib import Path

    pkg = Path(root).resolve() / "libpillowfight_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


PROFILE_TRIES = 3


def device_split(fn, iters: int = 5, kernels: tuple = ()) -> dict:
    """Device time of fn() by kernel name, ms a call (`torch.profiler`).
    With `kernels`, a trace that holds no row of those device functions,
    which fn() launches every call, lost its kernel records: it is taken
    again, up to PROFILE_TRIES traces, and the last one is returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
                split[e.key[:70]] = round(us / 1e3 / iters, 5)
        if not kernels or kernel_time(split, kernels) > 0:
            break
        log(f"profiler trace {attempt + 1} holds no row of {kernels} "
            f"(rows: {split})")
    return split


def in_turns(other, this, iters: int = 20) -> dict:
    """ms a call of two functions taken other, this, this, other."""
    order = (("other", other), ("this", this), ("this", this),
             ("other", other))
    times = {"other": [], "this": []}
    for who, fn in order:
        times[who].append(round(cuda_ms(fn, iters=iters), 4))
    return times


def against(root: str) -> int:
    """This tree's blur, line counts, pack, unpack, certificates, ball
    count, label kernel, ACE spray and timed paths against those of the
    tree at `root`, in turns in one process (see the module's
    docstring)."""
    import os

    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch.core import constants as C
    from libpillowfight_tpu_torch.core.bitmap import (words_to_gray,
                                                      words_to_pages)
    from libpillowfight_tpu_torch.ops.conv import gaussian_taps
    from libpillowfight_tpu_torch.ops.cuda import ace as spray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.ops.cuda import gaussian as gs
    from libpillowfight_tpu_torch.ops.cuda import label as lb
    from libpillowfight_tpu_torch.ops.cuda import linecount as lc
    from libpillowfight_tpu_torch.ops.cuda import noise
    from libpillowfight_tpu_torch.ops.unpaper.common import (dark_mask,
                                                             nonwhite_mask)
    from libpillowfight_tpu_torch.utils.pages import (synthetic_pages,
                                                      text_pages)
    tace = importlib.import_module("libpillowfight_tpu_torch.ops.ace")

    dev = torch.device("cuda", 0)
    card = ", ".join(card_name_and_power())
    log(card)
    other = load_tree(root, "pft_other")
    o_lb = importlib.import_module("pft_other.ops.cuda.label")
    o_spray = importlib.import_module("pft_other.ops.cuda.ace")
    importlib.import_module("pft_other._build").load()
    pt._build.load()
    result = {"card": card, "other": root}

    # the blur, the line counts, the pack, the unpack, the certificates and
    # the ball count on the same tensors
    o_gs = importlib.import_module("pft_other.ops.cuda.gaussian")
    o_lc = importlib.import_module("pft_other.ops.cuda.linecount")
    o_fp = importlib.import_module("pft_other.ops.cuda.flood_packed")
    o_noise = importlib.import_module("pft_other.ops.cuda.noise")
    words2 = words_on(synthetic_pages(CHECK_BATCH, A4_H, A4_W), dev)
    gray = words_to_gray(words2)
    taps = gaussian_taps(C.CANNY_GAUSSIAN_SIGMA, C.CANNY_GAUSSIAN_NB_STDDEV)
    blur_inputs = {"gray A4 x 2": gray, "RGB planes A4 x 2":
                   blur_planes_rgb(words2)}
    words600 = words_on(synthetic_pages(CHECK_BATCH, A4_600_H, A4_600_W), dev)
    gray600 = words_to_gray(words600)
    blur_inputs["gray A4 600 dpi x 2"] = gray600
    line_inputs = {"dark A4 x 2": dark_mask(gray),
                   "dark A4 600 dpi x 2": dark_mask(gray600)}
    cert_inputs = {"non-white A4 x 2": nonwhite_mask(gray),
                   "non-white A4 600 dpi x 2": nonwhite_mask(gray600)}
    del words600
    pairs = [("gaussian_sep", what, x, BLUR_KERNELS,
              lambda x=x: o_gs.gaussian_sep_cuda(x, taps),
              lambda x=x: gs.gaussian_sep_cuda(x, taps))
             for what, x in blur_inputs.items()]
    pairs += [("line_counts", what, x, LINE_COUNT_KERNELS,
               lambda x=x: o_lc.line_counts_cuda(x),
               lambda x=x: lc.line_counts_cuda(x))
              for what, x in line_inputs.items()]
    # the pack and the certificates; the other tree's certificates may
    # run as the ball count's template
    pairs += [("pack_rows", what, x, DEVICE_FUNCTIONS["pack_rows"],
               lambda x=x: o_fp.pack_rows_cuda(x),
               lambda x=x: fp.pack_rows_cuda(x))
              for what, x in line_inputs.items()]
    pairs += [("noise_cert", what, x,
               ("noise_cert_kernel", "noise_ball_kernel"),
               lambda x=x: o_noise.noise_cert_cuda(x, 2, 5),
               lambda x=x: noise.noise_cert_cuda(x, 2, 5))
              for what, x in cert_inputs.items()]
    # the unpack on the dark planes' words, the ball count at k = 1 on the
    # non-white planes
    word_inputs = {what: (fp.pack_rows_plain(x), x.shape[1])
                   for what, x in line_inputs.items()}
    pairs += [("unpack_rows", what, x, DEVICE_FUNCTIONS["unpack_rows"],
               lambda x=x, h=h: o_fp.unpack_rows_cuda(x, h),
               lambda x=x, h=h: fp.unpack_rows_cuda(x, h))
              for what, (x, h) in word_inputs.items()]
    pairs += [("noise_ball", what, x, DEVICE_FUNCTIONS["noise_ball"],
               lambda x=x: o_noise.noise_ball_cuda(x, 1),
               lambda x=x: noise.noise_ball_cuda(x, 1))
              for what, x in cert_inputs.items()]
    for name, what, x, names, was, now in pairs:
        a, b = was(), now()
        a, b = (a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{name} ({what}): the two trees differ")
        key = f"{name}, {what}"
        result[key] = {**in_turns(was, now),
                       "split other": three_way(was, names),
                       "split this": three_way(now, names)}
        r = result[key]
        log(f"{name} {what}: bit-identical to the other tree's; ms "
            f"{ {k: r[k] for k in ('other', 'this')} }; kernel / other "
            f"device / host ms a call: other "
            f"{r['split other']['kernel_ms']} / "
            f"{r['split other']['other_device_ms']} / "
            f"{r['split other']['host_ms']}, this "
            f"{r['split this']['kernel_ms']} / "
            f"{r['split this']['other_device_ms']} / "
            f"{r['split this']['host_ms']}")
    # what the certificates cost with no mask pixel (staging and the
    # transpose alone) and with every pixel a mask pixel (every row of
    # every warp takes the board work)
    x = cert_inputs["non-white A4 x 2"]
    for what, plane in (("empty plane", torch.zeros_like(x)),
                        ("full plane", torch.ones_like(x))):
        result[f"noise_cert split, this, {what}"] = device_split(
            lambda: noise.noise_cert_cuda(plane, 2, 5))
        log(f"noise_cert, {what}, A4 x {CHECK_BATCH}, j = 2, device ms a "
            f"call by kernel (this): "
            f"{result[f'noise_cert split, this, {what}']}")
    del pairs, blur_inputs, line_inputs, cert_inputs, word_inputs, gray
    del gray600, x, plane

    # the label kernel: SWT's planes, then the non-white plane
    swt2 = swt_stages(words_on(text_pages(CHECK_BATCH, A4_H, A4_W), dev),
                      keep_links=True)
    valid, links = swt2["valid"], swt2["links"]
    del swt2
    nonwhite = nonwhite_mask(words_to_gray(words2))
    planes = {"swt planes": (valid, links), "non-white, 8-connected":
              (nonwhite, None), "non-white, 4-connected":
              (nonwhite, lb.mask_links(nonwhite, 4))}
    for what, (v, l) in planes.items():
        if not torch.equal(o_lb.label_links_cuda(v, l),
                           lb.label_links_cuda(v, l)):
            raise AssertionError(f"label_links ({what}): the two trees "
                                 f"differ")
        result[f"label_links, {what}"] = in_turns(
            lambda: o_lb.label_links_cuda(v, l),
            lambda: lb.label_links_cuda(v, l))
        log(f"label_links A4 x {CHECK_BATCH}, {what}: bit-identical; ms "
            f"{result[f'label_links, {what}']}")
    for who, mod in (("other", o_lb), ("this", lb)):
        result[f"label_links split, {who}"] = device_split(
            lambda: mod.label_links_cuda(valid, links))
        log(f"label_links on SWT's planes, device ms a call by kernel "
            f"({who}): {result[f'label_links split, {who}']}")
    # what the new design costs with no pixel to label and with no gap
    for what, plane in (("empty plane", torch.zeros_like(nonwhite)),
                        ("plane without a gap", torch.ones_like(nonwhite))):
        result[f"label_links split, this, {what}"] = device_split(
            lambda: lb.label_links_cuda(plane, None))
        log(f"label_links, {what}, A4 x {CHECK_BATCH}, 8-connected, "
            f"device ms a call by kernel (this): "
            f"{result[f'label_links split, this, {what}']}")
    tiles = valid[:, :A4_H // 32 * 32, :A4_W // 64 * 64].reshape(
        CHECK_BATCH, A4_H // 32, 32, A4_W // 64, 64)
    result["swt planes"] = {
        "valid share": float(valid.float().mean()),
        "share of 64 x 32 tiles with a valid pixel":
            float(tiles.any(dim=4).any(dim=2).float().mean())}
    log(f"SWT's planes: {result['swt planes']}")
    del valid, links, nonwhite, planes, tiles

    # the ACE spray
    pages = words_to_pages(words2)
    b, h, w, _ = pages.shape
    sy, sx = tace.sample_coords(ACE_SEED, b, C.ACE_DEFAULT_NB_SAMPLES, h, w)
    sy, sx = sy.to(dev), sx.to(dev)
    planar, sval = tace.spray_inputs(pages, sy, sx)
    args = (planar, sy, sx, sval, C.ACE_DEFAULT_SLOPE, C.ACE_DEFAULT_LIMIT)
    was = o_spray.ace_spray_cuda(*args)
    for form, kw in (("default form", {}), ("exact difference",
                                            {"prescaled": False})):
        now = spray.ace_spray_cuda(*args, **kw)
        err_n, err_i, top = spray_errors(now, was)
        same = torch.equal(now[1], was[1])
        result[f"ace_spray, {form}"] = {
            **in_turns(lambda: o_spray.ace_spray_cuda(*args),
                       lambda: spray.ace_spray_cuda(*args, **kw), iters=10),
            "invd_bit_identical": same,
            "num_diff_share": err_n / (C.ACE_DEFAULT_LIMIT * top)}
        log(f"ace_spray A4 x {b}, S = {sy.shape[1]}, {form}: invd "
            f"bit-identical to the other tree's: {same} (max |diff| "
            f"{err_i}); num differs by {err_n / (C.ACE_DEFAULT_LIMIT * top):.2e} "
            f"of the largest possible sum; ms {result[f'ace_spray, {form}']}")
    del was, now, planar, sval, pages, words2

    # the five timed paths, other / this / this / other
    specs = {"swt (mode 0)": [("swt", {})], "chain": pt.DOCUMENT_CLEANUP,
             "EDGE_STACK": pt.EDGE_STACK,
             "ace (100 samples)": [("ace", {"seed": ACE_SEED})]}
    text = [words_on(text_pages(TIME_BATCH, A4_H, A4_W, seed=s), dev)
            for s in (0, 1)]
    dirty = [words_on(synthetic_pages(TIME_BATCH, A4_H, A4_W, seed=s), dev)
             for s in (0, 1)]

    def paths(name, spec, batches):
        times = {"other": [], "this": []}
        for who, mod in (("other", other), ("this", pt), ("this", pt),
                         ("other", other)):
            norm = mod.normalize_spec(spec)
            times[who].append(round(time_path(
                lambda x: mod.run_pipeline(x, norm), batches,
                f"{name} [{who}]", card), 4))
        result[f"path {name}"] = times

    def device_ms(name, batch):
        # the chain's device time a run (profiler): it spreads less than
        # the path's event time, which also waits for the host
        times = {}
        for who, mod in (("other", other), ("this", pt), ("this", pt),
                         ("other", other)):
            norm = mod.normalize_spec(pt.DOCUMENT_CLEANUP)
            times.setdefault(who, []).append(round(sum(device_split(
                lambda: mod.run_pipeline(batch, norm), iters=3).values()), 4))
        result[f"{name}, device ms a run"] = times
        log(f"{name} {tuple(batch.shape)}, device ms a run (profiler): "
            f"{times}")

    for name, spec in specs.items():
        paths(name, spec, text if name.startswith("swt") else dirty)
    device_ms("chain", dirty[0])
    del text, dirty
    dirty = [words_on(synthetic_pages(TIME_BATCH_600, A4_600_H, A4_600_W,
                                      seed=s), dev) for s in (0, 1)]
    paths("chain at 600 dpi", pt.DOCUMENT_CLEANUP, dirty)
    device_ms("chain at 600 dpi", dirty[0])
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/against.json", "w") as f:
        json.dump(result, f, indent=1)
    log(json.dumps(result))
    return 0


RATE_KERNEL_SOURCE = r"""
// Issue rate of one f32 instruction: every thread runs 8 independent
// chains of it, so that latency hides and the issue rate shows.
#include <cuda_runtime.h>
template <int OP>
__global__ void chains(float* out, const float* in, int iters) {
  float x[8], a = in[0], b = in[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = in[2] + threadIdx.x + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (OP == 0) asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x[j]) : "f"(a), "f"(b));
      if (OP == 1) asm volatile("add.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(a));
      if (OP == 2 && i % 2 == 0) asm volatile("max.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(a));
      if (OP == 2 && i % 2 == 1) asm volatile("min.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(b));
      if (OP == 3) asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(x[j]));
      if (OP == 4) asm volatile("fma.rn.sat.f32 %0, %0, %1, %2;" : "+f"(x[j]) : "f"(a), "f"(b));
      if (OP == 5) asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(a));
    }
  }
  float sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int issue_rate(int op, void* out, const void* in, int blocks,
                          int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  const float* i = (const float*)in;
  if (op == 0) chains<0><<<blocks, 256, 0, s>>>(o, i, iters);
  if (op == 1) chains<1><<<blocks, 256, 0, s>>>(o, i, iters);
  if (op == 2) chains<2><<<blocks, 256, 0, s>>>(o, i, iters);
  if (op == 3) chains<3><<<blocks, 256, 0, s>>>(o, i, iters);
  if (op == 4) chains<4><<<blocks, 256, 0, s>>>(o, i, iters);
  if (op == 5) chains<5><<<blocks, 256, 0, s>>>(o, i, iters);
  return (int)cudaGetLastError();
}
"""


def issue_rates() -> int:
    """Instructions a second the card issues of FMA, add, min/max, rsqrt,
    saturating FMA and multiply (a small kernel built here from
    `RATE_KERNEL_SOURCE`): what the count of issue slots in
    `csrc/ace_spray.cu`, the ACE bound and the blur's bound (a multiply
    and an add a tap, no FMA) rest on."""
    import ctypes
    import tempfile
    from pathlib import Path

    from libpillowfight_tpu_torch import _build

    card = ", ".join(card_name_and_power())
    log(card)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = Path(tmp) / "issue_rate.cu", Path(tmp) / "issue_rate.so"
        src.write_text(RATE_KERNEL_SOURCE)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(lib),
                        str(src)], check=True)
        fn = ctypes.CDLL(str(lib)).issue_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    vals = torch.tensor([0.999, 1.001, 1.0], dtype=torch.float32, device=dev)
    rates = {}
    for op, name in enumerate(("fma", "add", "min/max", "rsqrt", "fma.sat",
                               "mul")):
        def run():
            _build.check(fn(op, out.data_ptr(), vals.data_ptr(), blocks,
                            iters, _build.stream_of(out)), "issue_rate")
        ms = cuda_ms(run, iters=5)
        rates[name] = blocks * 256 * 8 * iters / (ms / 1e3)
        log(f"issue rate {name}: {rates[name]:.4e} /s "
            f"({rates[name] / rates['fma']:.3f} of fma), {ms:.4f} ms")
    log(json.dumps({"card": card, "issue_rates_per_s": rates}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--issue-rates"]:
        return issue_rates()
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        return against(sys.argv[2])
    if len(sys.argv) > 1:
        print("usage: chip_smoke.py [--against DIR | --issue-rates]",
              file=sys.stderr)
        return 2
    import libpillowfight_tpu_torch as pt
    from libpillowfight_tpu_torch import _build
    from libpillowfight_tpu_torch.core.bitmap import words_to_gray
    from libpillowfight_tpu_torch.ops.cuda import flood_packed as fp
    from libpillowfight_tpu_torch.utils import metrics
    from libpillowfight_tpu_torch.utils.pages import (synthetic_pages,
                                                      text_pages)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = ", ".join(card_name_and_power())
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path().name})")
    for src in ("gaussian_sep.cu", "linecount.cu", "label_links.cu",
                "ace_spray.cu", "flood_packed.cu", "noise_cert.cu"):
        for line in _build.resource_usage(src):
            log(f"ptxas {src}: {line}")

    cleanup = pt.normalize_spec(pt.DOCUMENT_CLEANUP)
    edges = pt.normalize_spec(pt.EDGE_STACK)
    ace_spec = pt.normalize_spec([("ace", {"seed": ACE_SEED})])
    swt_spec = pt.normalize_spec([("swt", {})])
    cleanup_k1 = pt.normalize_spec(
        [("unpaper_noisefilter", {"intensity": 1}) if name ==
         "unpaper_noisefilter" else (name, kw)
         for name, kw in pt.DOCUMENT_CLEANUP])
    words2_cpu = words_on(synthetic_pages(CHECK_BATCH, A4_H, A4_W), "cpu")
    words2 = words2_cpu.to(dev)
    text2 = words_on(text_pages(CHECK_BATCH, A4_H, A4_W), dev)
    words600_cpu = words_on(synthetic_pages(CHECK_BATCH, A4_600_H, A4_600_W),
                            "cpu")
    words600 = words600_cpu.to(dev)

    # 4. each kernel vs its plain version
    swt2 = swt_stages(text2, keep_links=True)
    timings = check_kernels(words2, swt2, words600)

    # 5. the paths on the card, each counted
    total = dict.fromkeys(KERNELS, 0)

    def drive(spec, name, expect, words=words2):
        out, counts = counted(lambda: pt.run_pipeline(words, spec), name,
                              expect)
        for k in total:
            total[k] += counts[k]
        return out

    out = drive(cleanup, "cleanup chain",
                ["line_counts", "pack_rows", "unpack_rows", "flood_round",
                 "noise_cert"])
    plain2 = check_chain(out, words2_cpu, cleanup, "cleanup chain")
    out = drive(edges, "edge stack",
                ["gaussian_sep", "gaussian_sep[hw10]", "pack_rows",
                 "flood_round", "unpack_rows"])
    check_edges(out, words2_cpu, edges)
    out = drive(ace_spec, "ace", ["ace_spray"])
    check_ace(out, words2)
    out = drive(cleanup_k1, "cleanup chain, noisefilter intensity 1",
                ["line_counts", "pack_rows", "unpack_rows", "flood_round",
                 "noise_ball"])
    check_chain(out, words2_cpu, cleanup_k1, "cleanup chain k=1")
    out = drive(swt_spec, "swt",
                ["gaussian_sep", "gaussian_sep[hw10]", "pack_rows",
                 "flood_round", "unpack_rows", "label_links"], text2)
    check_swt(out, text2, swt2, swt_spec,
              words_on(text_pages(1, *SWT_SMALL), dev))
    del swt2
    out = drive(cleanup, "cleanup chain, A4 600 dpi",
                ["flood_sweep", "line_counts", "noise_cert"], words600)
    check_chain(out, words600_cpu, cleanup, "cleanup chain 600 dpi")
    del out, words600, words600_cpu

    # 5b. the card's A4 outputs against the C oracle, each call counted
    check_oracle(total, dev, card)

    # 6. throughput at A4 x 16 (600 dpi: x 4), two distinct dirty batches.
    # swt goes first: its seconds of device work bring the card's clocks
    # up after the CPU-only check above, and the shorter paths are timed
    # on a card that is warm, as under sustained load.
    batches = [words_on(text_pages(TIME_BATCH, A4_H, A4_W, seed=s), dev)
               for s in (0, 1)]
    torch.cuda.reset_peak_memory_stats(dev)
    swt_ms = time_path(lambda x: pt.run_pipeline(x, swt_spec), batches,
                       "swt (mode 0)", card)
    log(f"swt peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    stages = swt_stages(batches[1])
    log(f"swt stages A4 x {TIME_BATCH} (CUDA events around each stage, ms): "
        + json.dumps({k: round(v, 2) for k, v in stages["ms"].items()})
        + f"; letters per page {stages['n_letters'].tolist()[:2]}...")
    del stages
    text16 = batches[0]
    batches = [words_on(synthetic_pages(TIME_BATCH, A4_H, A4_W, seed=s), dev)
               for s in (0, 1)]
    flood16 = blackfilter_flood_inputs(words_to_gray(batches[0]))
    time_packed_flood(fp.pack_rows_cuda(flood16[0]),
                      fp.pack_rows_cuda(flood16[1]), A4_H, A4_W, 20,
                      f"A4 x {TIME_BATCH}, blackfilter inputs")
    del flood16
    ms = time_path(lambda x: pt.run_pipeline(x, cleanup), batches,
                   "chain", card)
    log(f"unpaper_cleanup_pipeline_throughput "
        f"{TIME_BATCH * A4_H * A4_W / 1e3 / ms:.2f} MP/s")
    dt_s = metrics.device_time(pt.run_pipeline, batches[0], cleanup)
    log(f"chain A4 x {TIME_BATCH}: metrics.device_time {dt_s * 1e3:.2f} ms a "
        f"call (CUDA events over 8 calls back to back, median of 3) beside "
        f"time_path's {ms:.2f} ms (one call a reading, median of "
        f"{TIME_ITERS}) on {card}")
    time_path(lambda x: pt.run_pipeline(x, edges), batches, "EDGE_STACK",
              card)
    time_path(lambda x: pt.run_pipeline(x, ace_spec), batches,
              "ace (100 samples)", card)
    batches = [words_on(synthetic_pages(TIME_BATCH_600, A4_600_H, A4_600_W,
                                        seed=s), dev) for s in (0, 1)]
    time_path(lambda x: pt.run_pipeline(x, cleanup), batches,
              "chain at 600 dpi", card)
    time_sweep_flood(*blackfilter_flood_inputs(words_to_gray(batches[0])), 20,
                     f"A4 600 dpi x {TIME_BATCH_600}, blackfilter inputs")
    time_path(lambda x: pt.run_pipeline(x, edges), batches,
              "EDGE_STACK at 600 dpi", card)
    time_path(lambda x: pt.run_pipeline(x, ace_spec), batches,
              "ace (100 samples) at 600 dpi", card)
    batches = [words_on(text_pages(TIME_BATCH_600, A4_600_H, A4_600_W,
                                   seed=s), dev) for s in (0, 1)]
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    time_path(lambda x: pt.run_pipeline(x, swt_spec), batches,
              "swt (mode 0) at 600 dpi", card)
    log(f"swt at 600 dpi x {TIME_BATCH_600} peak device memory: "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    peak = max(peak, torch.cuda.max_memory_allocated(dev))
    del batches
    bw = metrics.measure_peak_hbm_bw(dev)
    log(f"measure_peak_hbm_bw: {bw / 1e9:.1f} GB/s (a 1 GiB device-to-device "
        f"copy, read and write counted; {bw / HBM_BYTES_PER_S:.1%} of the data "
        f"sheet's {HBM_BYTES_PER_S / 1e12:.2f} TB/s) on {card}")

    # 7. the façade, the runner and config 5, each call counted
    try:
        check_facade(total)
        check_runner(total, dev)
        config5(total, dev, card)
    finally:
        shutil.rmtree(corpus_dir(), ignore_errors=True)
    # 7b. the distribution layer, each call counted
    check_rows_sharded(total, dev, card)
    # 8. the headline measurement and the profile tools, each counted
    check_tools(total, plain2[:1])
    del plain2
    # last: reading the profiler's trace leaves the card idle for seconds
    idle_share(lambda x: pt.run_pipeline(x, swt_spec), text16,
               "swt (mode 0)", swt_ms)
    log(f"peak device memory from phase 6 on: "
        f"{max(peak, torch.cuda.max_memory_allocated(dev)) / 2**30:.2f} GiB")
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
