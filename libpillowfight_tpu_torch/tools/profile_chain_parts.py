"""Device time of the parts of the cleanup chain's filters (the
counterpart of the reference's `tools/profile_chain_parts.py`).

    python -m libpillowfight_tpu_torch.tools.profile_chain_parts

Each stage is what the port's filter calls, under the port's name: the
block statistics are the exact integer `block_counts` (the reference's
tool timed the f32 `block_sums`, on no path of the port), and the
grayfilter takes r+g+b from the words, as the chain gives it. The flood
of the blackfilter is the packed flood at A4 300 dpi and the sweep flood
past `morph.packed_fits`. The record goes to
`chiprun_out/profile_chain_parts_torch.json`. Raises without a card;
`measure(device="cpu")` computes every stage on the CPU and writes "not
measured" for every time.
"""

from __future__ import annotations

from ..core import constants as C
from ..core.bitmap import (pages_to_words, rgba_to_gray, words_to_gray,
                           words_to_s3)
from ..ops.morph import flood_reach, small_cluster_mask
from ..ops.unpaper.blurfilter import blurfilter_wipe_nonwhite
from ..ops.unpaper.common import (block_counts, coverage_from_blocks,
                                  dark_mask, f32, nonwhite_mask)
from ..ops.unpaper.grayfilter import grayfilter_wipe_planes_s3
from . import timing

BF = C.BLACKFILTER_SCAN_SIZE, C.BLACKFILTER_SCAN_STEP
BLUR = C.BLURFILTER_SIZE, C.BLURFILTER_STEP


def blackfilter_seeds(dark):
    """The blackfilter's seeds, as `blackfilter_wipe_dark` makes them:
    the dark pixels of the scan squares whose dark count reaches the
    threshold."""
    size, step = BF
    counts = block_counts(dark, size, step)
    trig = counts >= f32(C.BLACKFILTER_SCAN_THRESHOLD * size * size, counts)
    return coverage_from_blocks(trig, dark.shape, size, step) & dark


def dark_and_nonwhite(gray):
    return dark_mask(gray), nonwhite_mask(gray)


def measure(b: int = 8, h: int = timing.A4[0], w: int = timing.A4[1],
            iters: int = 4, device=None) -> dict:
    dev = timing.device(device)
    pages = timing.page_batches(b, h, w, dev, n=1)[0]
    words = pages_to_words(pages)
    gray = rgba_to_gray(pages)
    dark, nonwhite = dark_and_nonwhite(gray)
    p = timing.Profile("profile_chain_parts", dev, (b, h, w), iters)
    p.stage(f"blackfilter block_counts {BF[0]}/{BF[1]}", block_counts, dark,
            *BF)
    seeds = p.stage("blackfilter seeds (block_counts + coverage)",
                    blackfilter_seeds, dark)
    p.stage(f"blackfilter flood_reach leap={C.BLACKFILTER_INTENSITY}",
            lambda s, d: flood_reach(s, d, leap=C.BLACKFILTER_INTENSITY),
            seeds, dark)
    p.stage(f"noisefilter small_cluster_mask k={C.NOISEFILTER_INTENSITY}",
            small_cluster_mask, nonwhite, C.NOISEFILTER_INTENSITY)
    p.stage(f"blurfilter block_counts {BLUR[0]}/{BLUR[1]}", block_counts,
            nonwhite, *BLUR)
    p.stage("blurfilter full", blurfilter_wipe_nonwhite, nonwhite)
    p.stage("grayfilter full (s3 from words)",
            lambda d, x: grayfilter_wipe_planes_s3(d, words_to_s3(x)), dark,
            words)
    p.stage("dark + nonwhite from gray", dark_and_nonwhite, gray)
    p.stage("rgba_to_gray", rgba_to_gray, pages)
    p.stage("words_to_gray", words_to_gray, words)
    return p.rec


def main() -> None:
    print(f"wrote {timing.write('profile_chain_parts', measure())}")


if __name__ == "__main__":
    main()
