"""A PPM corpus read through the program's `io.ImagePageSource` into its
`parallel.BatchRunner`, closed loop: the runner keeps one chunk in
flight while the host decodes the next, as its users run it.

The window opens as the runner starts. Pages whose source call began
before the deadline are due; the window closes when the last of them
reaches the sink, and the pages per second are the due pages over that
time. The runner runs on past the deadline until that chunk is
delivered, so the chunks' overlap is not cut short.

Traffic parameters: height, width, dpi; chunk (pages a chunk); corpus
(distinct files, cycled); content; warm_chunks; sample_one_in (the share
of delivered pages compared); trace_seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.corpus import Corpus, Sink, TimedSource, WindowClosed
from benchmark.harness import log, mismatched_words
from benchmark.pages import make_pages

MAX_PAGES = 200_000   # the runner's page count: more than any window takes


def setup(ctx) -> dict:
    from libpillowfight_tpu_torch import io as pio
    from libpillowfight_tpu_torch.parallel import BatchRunner

    p = ctx.cell.params
    h, w, n = p["height"], p["width"], p["corpus"]
    t0 = time.perf_counter()
    pages = make_pages(ctx.seed, 0, n, h, w, p["dpi"], p["content"])
    corpus = Corpus(pages)
    ctx.on_exit(corpus.close)
    log(f"corpus: {n} distinct pages of {h} x {w} made and written as PPM "
        f"in {time.perf_counter() - t0:.3f} s (io codec: "
        f"{'native' if pio.available() else 'numpy'})")
    devices = None if ctx.device.type == "cuda" else ["cpu"]
    cycle = [corpus.paths[j % n] for j in range(MAX_PAGES)]
    warm = p["warm_chunks"] * p["chunk"]
    with pio.ImagePageSource(cycle[:warm], shape=(h, w)) as src:
        BatchRunner(ctx.cell.config["spec"], chunk_size=p["chunk"],
                    devices=devices).run(warm, src)
    ctx.sync()
    # a runner of its own for the window: the warm one has its chunks done
    runner = BatchRunner(ctx.cell.config["spec"], chunk_size=p["chunk"],
                         devices=devices)
    one_in = p["sample_one_in"]

    def sampled(j: int) -> bool:
        return np.random.default_rng([ctx.seed % (1 << 64), 2, j]).integers(
            one_in) == 0

    return {"pages": pages, "runner": runner, "cycle": cycle,
            "sampled": sampled, "shape": (h, w)}


def window(ctx, state) -> None:
    from libpillowfight_tpu_torch import io as pio

    run = ctx.run
    sink = Sink(state["sampled"], run.spans)
    with pio.ImagePageSource(state["cycle"], shape=state["shape"]) as src:
        source = TimedSource(src, run.spans, run.t_open + ctx.seconds)
        try:
            state["runner"].run(MAX_PAGES, source, sink)
        except WindowClosed:
            pass
        ctx.sync()
    run.window_s = sink.t_last - run.t_open
    run.pages = run.attempted = len(source.due)
    run.calls = len(source.due) // ctx.cell.params["chunk"]
    state["due"], state["sink"] = source.due, sink


def check(ctx, state) -> None:
    """Every due page delivered once, to its index, and nothing else;
    each sampled page against the reference of its file."""
    run, sink = ctx.run, state["sink"]
    due = set(state["due"])
    delivered = set(sink.count)
    missing = len(due - delivered)
    twice = sum(1 for c in sink.count.values() if c > 1)
    unexpected = len(delivered - due)
    del state["runner"]
    n = len(state["pages"])
    files = sorted({j % n for j in sink.kept})
    bad = 0
    for f in files:
        want = ctx.reference(state["pages"][f:f + 1], ctx.cell.config["spec"])
        for j, page in sink.kept.items():
            if j % n == f:
                got = torch.from_numpy(page).view(torch.int32).squeeze(-1)
                nbad = mismatched_words(got[None].to(want.device), want)
                bad += nbad
                run.failed += nbad > 0
    run.failed += missing + twice + unexpected
    run.compared = [("mismatched_pixels", bad, 0),
                    ("pages_missing", missing, 0),
                    ("pages_twice", twice, 0),
                    ("pages_unexpected", unexpected, 0)]
    log(f"delivery: {len(due)} pages due, {len(delivered)} delivered; "
        f"compared {len(sink.kept)} sampled pages of {len(files)} files with "
        f"the reference")
