"""The files cells' corpus and the runner's instrumented source and
sink.

Frozen from the port's `chip_smoke.py` (`write_corpus`, `TimedSource`,
`PageCheck`): the corpus is written as binary PPM into a fresh directory
under TMPDIR and removed at exit; the source records each call as a span
and closes the window; the sink takes each page into host memory,
counts deliveries by index and keeps a seeded sample for the comparison.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np


def write_ppm(path: str, page: np.ndarray) -> None:
    """uint8 RGBA [H, W, 4] as a binary PPM (RGB, maxval 255), on disk
    before it returns, so that no write-back of the corpus falls into
    the window."""
    h, w = page.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(page[..., :3]).tobytes())
        f.flush()
        os.fsync(f.fileno())


class Corpus:
    """The pages as PPM files in a fresh directory under TMPDIR."""

    def __init__(self, pages: np.ndarray):
        self.dir = tempfile.mkdtemp(prefix="bench-corpus-")
        self.paths = []
        for i, page in enumerate(pages):
            self.paths.append(os.path.join(self.dir, f"page_{i:03d}.ppm"))
            write_ppm(self.paths[-1], page)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class WindowClosed(Exception):
    """Raised by the source to end the runner once the window is over."""


class TimedSource:
    """A runner's source that records each call as a `source` span. The
    pages of calls that begin before the deadline are due in the window.
    The first call after it is served, so that the chunk in flight is
    completed as the runner completes it (after dispatching the next);
    the second raises WindowClosed."""

    def __init__(self, src, spans, deadline: float):
        self.src, self.spans, self.deadline = src, spans, deadline
        self.due: list = []
        self.late = 0

    def __call__(self, idx):
        if time.perf_counter() >= self.deadline:
            self.late += 1
            if self.late > 1:
                raise WindowClosed
        else:
            self.due.extend(int(j) for j in idx)
        with self.spans("source"):
            return self.src(idx)


class Sink:
    """Takes each delivered page into host memory, counts deliveries by
    index, keeps a copy of the pages that `sampled(j)` picks, and
    records when the last chunk of due pages arrived."""

    def __init__(self, sampled, spans):
        self.sampled, self.spans = sampled, spans
        self.count: dict = {}
        self.kept: dict = {}
        self.t_last = None

    def __call__(self, idx, out) -> None:
        with self.spans("sink"):
            for i, j in enumerate(idx):
                j = int(j)
                self.count[j] = self.count.get(j, 0) + 1
                if self.sampled(j):
                    self.kept[j] = np.array(out[i])
        self.t_last = time.perf_counter()
