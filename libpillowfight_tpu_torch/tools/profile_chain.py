"""Device time of the unpaper cleanup chain stage by stage (the
counterpart of the reference's `tools/profile_chain.py`).

    python -m libpillowfight_tpu_torch.tools.profile_chain [--b 8]
        [--iters 4] [--h 3508] [--w 2480]

On b pages of `utils.pages.synthetic_pages`: gray from RGBA, each of the
six wipes alone on the gray plane, their sum, and the chain through
`run_pipeline` on RGBA and on int32 words. A stage's time is
`metrics.device_time` (calls back to back). `--h 7016 --w 4960 --b 2` is
the chain at A4 600 dpi, where the blackfilter takes the sweep flood.
The record goes to `chiprun_out/profile_chain_torch.json`. Raises without
a card; `measure(device="cpu")` computes every stage on the CPU and
writes "not measured" for every time.
"""

from __future__ import annotations

import argparse

from ..core.bitmap import pages_to_words, rgba_to_gray
from ..ops.unpaper.blackfilter import blackfilter_wipe
from ..ops.unpaper.blurfilter import blurfilter_wipe
from ..ops.unpaper.border import border_wipe
from ..ops.unpaper.grayfilter import grayfilter_wipe
from ..ops.unpaper.masks import masks_wipe
from ..ops.unpaper.noisefilter import noisefilter_wipe
from ..parallel.pipeline import DOCUMENT_CLEANUP, normalize_spec, run_pipeline
from . import timing

# the chain's order
WIPES = {"blackfilter_wipe": blackfilter_wipe,
         "noisefilter_wipe": noisefilter_wipe,
         "blurfilter_wipe": blurfilter_wipe,
         "masks_wipe": masks_wipe,
         "grayfilter_wipe": grayfilter_wipe,
         "border_wipe": border_wipe}
CHAIN_RGBA = "fused chain (RGBA u8 in/out)"
CHAIN_WORDS = "fused chain (int32 words in/out)"


def measure(b: int = 8, h: int = timing.A4[0], w: int = timing.A4[1],
            iters: int = 4, device=None) -> dict:
    dev = timing.device(device)
    pages = timing.page_batches(b, h, w, dev, n=1)[0]
    p = timing.Profile("profile_chain", dev, (b, h, w), iters)
    gray = p.stage("rgba_to_gray", rgba_to_gray, pages)
    for name, fn in WIPES.items():
        p.stage(name, fn, gray)
    p.total("sum of stages", WIPES)
    spec = normalize_spec(DOCUMENT_CLEANUP)
    p.stage(CHAIN_RGBA, run_pipeline, pages, spec)
    p.stage(CHAIN_WORDS, run_pipeline, pages_to_words(pages), spec)
    return p.rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--h", type=int, default=timing.A4[0])
    ap.add_argument("--w", type=int, default=timing.A4[1])
    args = ap.parse_args(argv)
    rec = measure(args.b, args.h, args.w, args.iters)
    print(f"wrote {timing.write('profile_chain', rec)}")


if __name__ == "__main__":
    main()
