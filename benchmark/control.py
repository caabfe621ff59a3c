"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(bfloat16 gray and gradient planes for float32), over the inputs a run
compares, at the cell's own size. It must come out as not correct:
`mismatched_pixels` above its limit of 0 on every seed.

    python benchmark/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed. Not part of the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") not in (HERE, ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.drivers.resident import draws  # noqa: E402
from benchmark.harness import Run, load_cell, mismatched_words  # noqa: E402
from benchmark.pages import make_pages  # noqa: E402
from benchmark.run import Context  # noqa: E402


def compared_pages(cell, seed: int):
    """The host pages whose outputs a run of the cell compares: the drawn
    pages of every distinct batch of a resident cell, every file of a
    files cell."""
    p = cell.params
    make = lambda first, n: make_pages(  # noqa: E731
        seed, first, n, p["height"], p["width"], p["dpi"], p["content"])
    if "corpus" in p:
        return make(0, p["corpus"])
    _, picks = draws(seed, p)
    b = p["batch"]
    return np.concatenate([make(j * b, b)[pick]
                           for j, pick in enumerate(picks)])


def control(cell, seed: int, device, low=torch.bfloat16) -> dict:
    pages = compared_pages(cell, seed)
    spec = cell.config["spec"]
    run = Run(cell=cell)
    want = Context(cell, seed, 0, device, run).reference(pages, spec)
    got = Context(cell, seed, 0, device, run, ref_dtype=low).reference(
        pages, spec)
    return {"workload": cell.name, "seed": seed, "precision": str(low),
            "pages": len(pages), "mismatched_pixels":
            mismatched_words(got, want), "limit": 0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control(cell, seed, device)
        out["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
