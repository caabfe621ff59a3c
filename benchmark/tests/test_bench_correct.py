"""A run driven on the CPU at a small size (the harness's look for a
card skipped): correct when the program is sound, not correct when the
timed path is broken underneath, and the control, the reference in
bfloat16 in the program's place, not correct either."""

import json
import time

import pytest
import torch

from benchmark.control import control
from benchmark.harness import load_cell
from benchmark.run import run_cell
from libpillowfight_tpu_torch.parallel import pipeline
from benchmark.tests.tests_support import small_cell

torch.set_num_threads(4)
CELLS = ["cleanup-a4-300-resident", "cleanup-a4-600-resident",
         "ocr-prep-a4-300-files"]


def one_run(name):
    cell = small_cell(name)
    line = run_cell(cell, 2**31 + 99, 1.0, False, torch.device("cpu"),
                    time.perf_counter())
    return json.loads(line)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = one_run(name)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"pages_per_s", "setup_s"}


def _unchanged(run, pages, spec):
    return pages


def _half_left_out(run, pages, spec):
    out = run(pages, spec).clone()
    half = pages.shape[0] // 2
    out[half:] = pages[half:]
    return out


def _answer_altered(run, pages, spec):
    out = run(pages, spec).clone()
    out.view(-1)[0] ^= 1
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    real = pipeline.run_pipeline

    def broken(pages, spec):
        if isinstance(pages, pipeline.ShardedPages):
            return real(pages, spec)  # its shards come back through here
        return fault(real, pages, spec)

    monkeypatch.setattr(pipeline, "run_pipeline", broken)
    out = one_run(name)
    assert not out["correct"]
    assert out["compared"]["mismatched_pixels"]["value"] > 0


@pytest.mark.parametrize("name,size", [
    ("cleanup-a4-300-resident", (3508, 2480)),
    ("ocr-prep-a4-300-files", (1200, 900))])
def test_control_is_not_correct(name, size):
    cell = load_cell(name)
    p = cell.params
    p.update(height=size[0], width=size[1])
    p.update(corpus=1) if "corpus" in p else p.update(batch=1,
                                                      distinct_batches=1)
    out = control(cell, 2**31 + 5, torch.device("cpu"))
    assert out["mismatched_pixels"] > out["limit"]
