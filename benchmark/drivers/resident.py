"""Batches of int32 words resident on the card, each call of the
configuration's compiled pipeline timed in a closed loop: one caller
issues a batch, waits until its output is ready, and issues the next.

Traffic parameters (the cell's `params`): height, width, dpi; batch
(pages a call); distinct_batches (taken in turns); content (the page
generator's mix); warm_calls; trace_seconds (the traced run's window);
compare_within (the calls among which each distinct batch's compared
output is drawn); compare_pages (the pages of a compared call, drawn
from the seed over the whole batch, whose outputs are compared).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import log, mismatched_words
from benchmark.pages import make_pages


def draws(seed: int, p: dict):
    """From the seed: the calls whose outputs are compared, one a distinct
    batch (the last call is compared too), and the pages of each distinct
    batch that are compared."""
    b, nb = p["batch"], p["distinct_batches"]
    rng = np.random.default_rng([seed % (1 << 64), 1])
    keep = {int(j + nb * rng.integers(0, p["compare_within"]))
            for j in range(nb)}
    picks = [np.sort(rng.choice(b, min(b, p["compare_pages"]),
                                replace=False)) for _ in range(nb)]
    return keep, picks


def setup(ctx) -> dict:
    import libpillowfight_tpu_torch as pt

    p = ctx.cell.params
    b, h, w, nb = p["batch"], p["height"], p["width"], p["distinct_batches"]
    keep, picks = draws(ctx.seed, p)
    t0 = time.perf_counter()
    words, host = [], []
    for j in range(nb):  # one batch on the host at a time
        pages = make_pages(ctx.seed, j * b, b, h, w, p["dpi"], p["content"])
        words.append(torch.from_numpy(pages).view(torch.int32).squeeze(-1)
                     .to(ctx.device))
        host.append(pages[picks[j]])
        del pages
    log(f"pages: {nb} x {b} distinct pages of {h} x {w} made and placed in "
        f"{time.perf_counter() - t0:.3f} s")
    fn = pt.compile_pipeline(ctx.cell.config["spec"])
    for i in range(p["warm_calls"]):
        fn(words[i % nb])
    ctx.sync()
    return {"host": host, "words": words, "fn": fn, "keep": keep,
            "picks": [torch.as_tensor(x, device=ctx.device) for x in picks],
            "kept": {}}


def window(ctx, state) -> None:
    run, fn, words = ctx.run, state["fn"], state["words"]
    nb, b = len(words), ctx.cell.params["batch"]
    deadline = run.t_open + ctx.seconds
    ms = []
    i = 0
    while True:
        t0 = time.perf_counter()
        with run.spans("pipeline"):
            out = fn(words[i % nb])
        ctx.sync()
        t1 = time.perf_counter()
        ms.append(1e3 * (t1 - t0))
        last = t1 >= deadline
        if i in state["keep"] or last:
            state["kept"][i] = out[state["picks"][i % nb]]
        out = None  # its memory serves the next call
        i += 1
        if last:
            break
    run.window_s = t1 - run.t_open
    run.calls, run.pages = i, i * b
    run.batch_ms = ms
    run.attempted = i


def check(ctx, state) -> None:
    """The kept pages of each compared call against the reference of the
    same host pages, after the window."""
    run, spec = ctx.run, ctx.cell.config["spec"]
    nb = len(state["words"])
    del state["words"], state["fn"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want: dict = {}
    bad = pages = 0
    for i, got in sorted(state["kept"].items()):
        j = i % nb
        if j not in want:
            want[j] = ctx.reference(state["host"][j], spec)
        n = mismatched_words(got, want[j])
        bad += n
        pages += got.shape[0]
        run.failed += n > 0
    run.compared = [("mismatched_pixels", bad, 0)]
    log(f"compared {pages} output pages of {len(state['kept'])} calls with "
        f"the reference")
