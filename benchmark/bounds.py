"""The least time of each of the program's kernel entries, from the work
its operation needs: the planes it reads and writes, each once, at the
card's memory rate, or its operations at the card's float32 rate,
whichever is longer.

Frozen from the port's `chip_smoke.py` (`bound` and its per-kernel
counts) and `utils/metrics.py` (the peaks). The peaks are NVIDIA's H100
SXM data sheet at its 700 W limit; the harness prints the card's power
limit beside every run.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # HBM3, 80 GB
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
SLOTS_PER_S = F32_OPS_PER_S / 2     # an instruction that is no FMA counts 2
SFU_OPS_PER_S = SLOTS_PER_S / 8     # special-function results
ACE_SLOTS_PER_PIXEL_SAMPLE = 11     # the ACE spray's work a pixel and sample
BLUR_TAPS = 21                      # canny's and swt's Gaussian (sigma 2, 5 sd)
ACE_SAMPLES = 100


def least_seconds(n_bytes: float, n_ops: float = 0.0,
                  n_sfu: float = 0.0) -> float:
    """The least time for the work: bytes at the memory rate, or the
    float32 operations, or the special-function results, whichever is
    longest."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S,
               n_sfu / SFU_OPS_PER_S)


def _plane(b, h, w):
    """Bytes of a bool or byte plane of b pages of h x w."""
    return b * h * w


def _words(b, h, w):
    """Bytes of its packed form: ceil(h/32) int32 words a column."""
    return b * ((h + 31) // 32) * w * 4


def _blur(b, h, w):
    n = b * h * w    # f32 gray planes; 2 passes of 21 FMUL + 20 FADD
    return least_seconds(8 * n, 4 * (2 * BLUR_TAPS - 1) * n)


def _ace(b, h, w):
    n = b * h * w * ACE_SAMPLES  # 3 f32 planes in, 4 out; 11 slots a pixel-sample
    return least_seconds(28 * b * h * w, 2 * ACE_SLOTS_PER_PIXEL_SAMPLE * n, n)


# The least time of one call of each of the program's kernel entries, as
# the pipeline calls it on a batch of b pages of h x w, by the name of
# its launch counter (`harness.program_counters`).
WORK = {
    # a plane in, row and column counts out
    "linecount": lambda b, h, w: least_seconds(
        _plane(b, h, w) + 4 * (b * h + b * w)),
    # a plane <-> its words
    "pack_rows": lambda b, h, w: least_seconds(_plane(b, h, w) + _words(b, h, w)),
    "unpack_rows": lambda b, h, w: least_seconds(
        _plane(b, h, w) + _words(b, h, w)),
    # one launch a flood: seeds, mask in, reach out
    "flood_round": lambda b, h, w: least_seconds(3 * _words(b, h, w)),
    # a launch: mask and reach in, reach out
    "flood_sweep": lambda b, h, w: least_seconds(3 * _plane(b, h, w)),
    # a plane in, certificates and mask words out
    "noise_cert": lambda b, h, w: least_seconds(
        _plane(b, h, w) + 2 * _words(b, h, w)),
    # a plane in, the small pixels out
    "noise_ball": lambda b, h, w: least_seconds(2 * _plane(b, h, w)),
    # one page a call: valid and 4 links in, labels out
    "label": lambda b, h, w: least_seconds(5 * h * w + 4 * h * w),
    "gaussian": _blur,
    "ace": _ace,
}


def entry_seconds(entry: str, b: int, h: int, w: int) -> float | None:
    """The least time of one call of a kernel entry at b x h x w; None for
    an entry that has no work model here."""
    work = WORK.get(entry)
    return None if work is None else work(b, h, w)
