"""Every configuration, cell and metric is a file of its own, found by
name, and ``BENCHMARK.json`` agrees with them."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = os.path.dirname(harness.BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", harness.names("workloads", ".json"))
def test_cell_loads_by_name(cell):
    cell_d, config = harness.load_cell(cell)
    assert NAME.match(cell) and NAME.match(cell_d["config"])
    driver = harness.module("samplers", cell_d["sampler"])
    reference = harness.module("reference", cell_d["sampler"])
    assert callable(driver.job) and callable(reference.check)
    assert callable(reference.stand_in)
    harness.module("roofline", cell_d["kernel"])
    assert len(config["std"]) == len(config["loc"]) == config["dim"]
    assert set(cell_d["limits"]) and all(v > 0 for v in
                                         cell_d["limits"].values())
    assert cell_d["chips"] == 1


@pytest.mark.parametrize("metric", harness.names("metrics", ".py"))
def test_metric_loads_by_name(metric):
    mod = harness.module("metrics", metric)
    assert mod.NAME == metric and NAME.match(metric)
    assert mod.SOURCE in ("device_trace", "program_span", "program_counter",
                          "host_clock")
    assert callable(mod.read)


def test_benchmark_json_names_the_files():
    spec = _spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert set(cells) <= set(harness.names("workloads", ".json"))
    configs = {c["name"]: c for c in spec["configs"]}
    for name, w in cells.items():
        cell, _ = harness.load_cell(name)
        assert (w["config"], w["traffic"]) == (cell["config"],
                                               cell["traffic"])
        assert w["chips"] == cell["chips"] and w["why"] == cell["why"]
        assert configs[w["config"]]["file"] == (
            "benchmark/configs/{}.json".format(w["config"]))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert e2e == {"ess_per_s", "draws_per_s", "job_p90_s", "setup_s"}
    for m in spec["per_layer"]:
        mod = harness.module("metrics", m["name"])
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
            mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE)
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)


def test_new_cell_is_found_without_editing(tmp_path):
    """A cell file added to a copy of the benchmark is found by name, and
    nothing else is edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("_out", "_cache",
                                                  "__pycache__"))
    with open(copy / "workloads" / "hmc.neal100d.32k.json") as f:
        cell = json.load(f)
    cell["chains"] = 1024
    with open(copy / "workloads" / "hmc.neal100d.1k.json", "w") as f:
        json.dump(cell, f)
    code = ("from benchmark import harness; c, cfg = harness.load_cell("
            "'hmc.neal100d.1k'); print(c['chains'], "
            "'hmc.neal100d.1k' in harness.names('workloads', '.json'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["1024", "True"]
