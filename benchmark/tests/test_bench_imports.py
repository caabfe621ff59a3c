"""What a run loads: nothing of the JAX stack or the JAX package, and
the reference nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import FORBIDDEN, HERE, ROOT, forbidden_modules

PROGRAM = ("libpillowfight_tpu_torch", "pillowfight_torch")


def test_names_are_compared_whole(monkeypatch):
    fake = {"libpillowfight_tpu_torch": None, "libpillowfight_tpu_torch.io":
            None, "jaxtyping": None, "pillowfight_torch": None}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"jax.numpy": None,
                                                       "pillowfight": None}))
    assert forbidden_modules() == ["jax.numpy", "pillowfight"]


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, time, torch\n"
        "from benchmark.tests.tests_support import small_cell\n"
        "from benchmark.run import run_cell\n"
        "line = run_cell(small_cell('ocr-prep-a4-300-files'), 3, 0.5, False,"
        " torch.device('cpu'), time.perf_counter())\n"
        "assert json.loads(line)['correct']\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in PROGRAM + FORBIDDEN, (f, n)
    code = ("import sys; import benchmark.reference\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{PROGRAM + FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
