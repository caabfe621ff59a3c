"""The port's two floods priced on the card: a few rounds, the whole
flood, and the rounds it takes (the counterpart of the reference's
`tools/profile_flood.py`).

    python -m libpillowfight_tpu_torch.tools.profile_flood

On the reference tool's scan-like mask at A4 300 dpi x 2 (a black border
60 px wide, 6-px text lines every 40 px, 0.1% speckle from seed 0;
seeds: the mask's first 20 columns), leap 1:

- the packed flood on words (the route of `flood_reach` at A4 300 dpi)
  with `max_iters` 1, 2 and 4 (it runs two rounds at least), and the
  rounds it ran;
- the sweep flood on byte planes (the route past `morph.packed_fits`)
  with `max_iters` 1, 2 and 4, and its launches (each a sweep down and a
  sweep up);
- `flood_reach` in total (pack, flood, unpack) and its rounds, where the
  page passes `morph.packed_fits`, and the sweep flood to its fixed
  point and its launches.

The reference's tool compared two XLA lowerings of the segmented OR,
which the port does not have; its counterpart here prices the port's
two floods on the same mask. The record goes to
`chiprun_out/profile_flood_torch.json`. Raises without a card;
`measure(device="cpu")` computes every stage on the CPU (the plain
versions: rounds counted, launches "not measured") and writes "not
measured" for every time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import flood_packed as fp
from ..ops.cuda import flood_sweep as fs
from ..ops.morph import flood_reach, packed_fits
from . import timing

ROUNDS = (1, 2, 4)


def scan_mask(b: int, h: int, w: int, seed: int = 0):
    """(seeds, mask), bool [b,h,w] numpy: the reference tool's mask (the
    speckle shared by every page) and seeds in its first 20 columns."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, h, w), bool)
    mask[:, :, :60] = True
    for y in range(100, h - 100, 40):
        mask[:, y: y + 6, 200: w - 200] = True
    mask |= rng.random((h, w)) < 0.001
    seeds = np.zeros_like(mask)
    seeds[:, :, :20] = True
    return seeds & mask, mask


def packed_rounds(seeds_w, mask_w, h: int, w: int, leap: int = 1,
                  max_iters=None):
    """(reach words, rounds run) of the packed flood: on the card the
    kernel's count, on the CPU the plain version's rounds, which it runs
    as the kernel does (`rounds_of_last_flood`, the final round that
    changes nothing included)."""
    out = fp.flood_packed(seeds_w, mask_w, h, w, leap, max_iters)
    return out, fp.rounds_of_last_flood()


def sweep_launches(seeds, mask, leap: int = 1, max_iters=None):
    """(reach, launches of the sweep kernel) of the sweep flood; the
    launches are "not measured" on the CPU, where no kernel runs."""
    before = fs.launches
    out = fs.flood_sweep(seeds, mask, leap, max_iters)
    return out, (fs.launches - before if seeds.is_cuda
                 else timing.NOT_MEASURED)


def measure(b: int = 2, h: int = timing.A4[0], w: int = timing.A4[1],
            iters: int = 3, device=None) -> dict:
    dev = timing.device(device)
    seeds, mask = (torch.from_numpy(x).to(dev) for x in scan_mask(b, h, w))
    seeds_w, mask_w = fp.pack_rows(seeds), fp.pack_rows(mask)
    p = timing.Profile("profile_flood", dev, (b, h, w), iters)
    p.rec["rounds"], p.rec["launches"] = {}, {}
    for n in ROUNDS:
        label = f"packed flood, max_iters={n}"
        p.stage(label, lambda s, m, n=n: fp.flood_packed(s, m, h, w, 1, n),
                seeds_w, mask_w)
        p.rec["rounds"][label] = packed_rounds(seeds_w, mask_w, h, w, 1,
                                               n)[1]
    for n in ROUNDS:
        label = f"sweep flood, max_iters={n}"
        p.stage(label, lambda s, m, n=n: fs.flood_sweep(s, m, 1, n), seeds,
                mask)
        p.rec["launches"][label] = sweep_launches(seeds, mask, 1, n)[1]
    if packed_fits(h, w):
        label = "flood_reach (packed route: pack + flood + unpack)"
        p.stage(label, flood_reach, seeds, mask)
        p.rec["rounds"][label] = packed_rounds(seeds_w, mask_w, h, w)[1]
    label = "sweep flood to its fixed point"
    p.stage(label, fs.flood_sweep, seeds, mask)
    p.rec["launches"][label] = sweep_launches(seeds, mask)[1]
    print(f"rounds: {p.rec['rounds']}\nlaunches: {p.rec['launches']}",
          flush=True)
    return p.rec


def main() -> None:
    print(f"wrote {timing.write('profile_flood', measure())}")


if __name__ == "__main__":
    main()
