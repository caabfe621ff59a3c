"""Every configuration, cell, driver and metric that BENCHMARK.json
names is a file of its own, found by name, and agrees with the entry."""

import json
import os

import pytest

from benchmark.harness import HERE, ROOT, load_cell, load_json, load_module

BENCH = load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_file_agrees_with_its_entry(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = load_cell(name, BENCH)
    for key in ("config", "traffic", "chips", "why"):
        assert cell.workload[key] == entry[key]
    driver = load_module("drivers", cell.workload["driver"])
    for fn in ("setup", "window", "check"):
        assert callable(getattr(driver, fn))
    reported = {m["name"] for m in cell.e2e}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.e2e + cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_agrees_with_its_entry(entry):
    import libpillowfight_tpu_torch as pt

    config = load_json(ROOT, entry["file"])
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["why"] == entry["why"]
    assert config["reduced"] == entry["reduced"]
    assert all(k in config for k in config["reduced"])
    # the spec as the program takes it, every parameter written out
    pt.normalize_spec(config["spec"])
    assert all(params for _, params in config["spec"])


def test_every_file_is_named_by_the_benchmark():
    names = {
        "configs": {c["name"] for c in BENCH["configs"]},
        "workloads": set(CELLS),
        "metrics": {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]},
    }
    for kind, want in names.items():
        have = {f[:-len(".json")] if f.endswith(".json") else f[:-len(".py")]
                for f in os.listdir(os.path.join(HERE, kind))
                if f.endswith((".json", ".py"))}
        assert have == want, kind
    drivers = {json.load(open(os.path.join(HERE, "workloads", f"{c}.json")))
               ["driver"] for c in CELLS}
    assert drivers == {f[:-3] for f in os.listdir(os.path.join(HERE, "drivers"))
                       if f.endswith(".py")}


def test_metric_entries_keep_the_contract():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # every per-layer entry lists its cells
            c = load_cell(cell, BENCH)
            assert m["moves"] in {x["name"] for x in c.e2e}
