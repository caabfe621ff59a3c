"""One short run of each cell on the card, the result line as the
benchmark's driver reads it (skips without a card)."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
