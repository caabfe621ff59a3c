"""The blackfilter taken apart on the card: statistics against flood, the
flood's rounds, and one launch of the sweep kernel (the counterpart of
the reference's `tools/profile_blackfilter.py`).

    python -m libpillowfight_tpu_torch.tools.profile_blackfilter

Runs at A4 300 dpi x 8, as the reference's tool does, where the flood
takes the packed route (`morph.packed_fits`), and at A4 600 dpi x 2,
where it takes the sweep flood. Stages: the wipe in total; the
statistics (dark plane, `block_counts`, coverage: the seeds); the flood
in total at leap 20, with its rounds (packed: `rounds_of_last_flood`, the
final round that changes nothing included) or its launches (sweep: each
a sweep down and a sweep up); one launch of the sweep kernel at leap 20
and at leap 1. The reference's tool timed one sweep down; the port's
kernel sweeps down and up in one launch. A launch grows its reach plane
in place, and on a plane that has stopped growing it does less, so each
timed launch starts from the seeds again: the copy that restores them is
timed as a stage of its own. The records go to
`chiprun_out/profile_blackfilter_torch.json`. Raises without a card;
`measure(device="cpu")` computes every stage on the CPU (one round of the
plain sweep flood in place of a launch) and writes "not measured" for
every time.
"""

from __future__ import annotations

import torch

from ..core import constants as C
from ..core.bitmap import rgba_to_gray
from ..ops.cuda import flood_packed as fp
from ..ops.cuda import flood_sweep as fs
from ..ops.morph import flood_reach, packed_fits
from ..ops.unpaper.blackfilter import blackfilter_seeds, blackfilter_wipe
from ..ops.unpaper.common import dark_mask
from . import timing
from .profile_flood import packed_rounds, sweep_launches

LEAP = C.BLACKFILTER_INTENSITY
SHAPES = ((8, *timing.A4), (2, *timing.A4_600))


def seeds_from_gray(gray):
    """dark plane, block counts and coverage: the flood's seeds."""
    return blackfilter_seeds(dark_mask(gray))


def flood_count(seeds, dark, leap: int) -> dict:
    """The flood of `flood_reach` (pack, flood, unpack on the packed
    route), once, with its route and count: rounds of the packed flood,
    launches of the sweep flood (`profile_flood.packed_rounds`,
    `sweep_launches`)."""
    b, h, w = dark.shape
    if packed_fits(h, w):
        reach_w, rounds = packed_rounds(fp.pack_rows(seeds),
                                        fp.pack_rows(dark), h, w, leap)
        return {"reach": fp.unpack_rows(reach_w, h), "route": "packed",
                "rounds": rounds}
    reach, launches = sweep_launches(seeds, dark, leap)
    return {"reach": reach, "route": "sweep", "launches": launches}


def sweep_launch(dark, seeds, reach, changed, leap: int):
    """One launch of the sweep kernel (down and up) from the seeds: reach
    is set to the seeds first. On the CPU, where there is no kernel, one
    round of the plain sweep flood."""
    if not dark.is_cuda:
        return fs.flood_sweep_plain(seeds, dark, leap, max_iters=1)
    reach.copy_(seeds)
    fs.sweep_cuda(dark, reach, changed, leap)
    return reach


def measure(b: int = 8, h: int = timing.A4[0], w: int = timing.A4[1],
            iters: int = 5, device=None) -> dict:
    dev = timing.device(device)
    pages = timing.page_batches(b, h, w, dev, n=1)[0]
    gray = rgba_to_gray(pages)
    p = timing.Profile("profile_blackfilter", dev, (b, h, w), iters)
    p.stage("blackfilter_wipe total", blackfilter_wipe, gray)
    seeds = p.stage("statistics (dark + block_counts + coverage)",
                    seeds_from_gray, gray)
    dark = dark_mask(gray)
    flood = flood_count(seeds, dark, LEAP)
    count = {k: v for k, v in flood.items() if k != "reach"}
    p.rec["flood"] = count
    print(f"flood at leap {LEAP}: {count}", flush=True)
    p.stage(f"flood total (leap={LEAP}, {flood['route']} route)",
            lambda s, d: flood_reach(s, d, leap=LEAP), seeds, dark)
    reach = torch.empty_like(seeds)
    changed = torch.zeros(1, dtype=torch.int64, device=dev)
    p.stage("reach plane set to the seeds (copy)", reach.copy_, seeds)
    for leap in (LEAP, 1):
        p.stage(f"one sweep launch, down + up (leap={leap})", sweep_launch,
                dark, seeds, reach, changed, leap)
    return p.rec


def main() -> None:
    recs = [measure(b, h, w) for b, h, w in SHAPES]
    print(f"wrote {timing.write('profile_blackfilter', recs)}")


if __name__ == "__main__":
    main()
