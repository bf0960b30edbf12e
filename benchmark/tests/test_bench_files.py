"""Every configuration, target, cell and metric is a file of its own,
found by name, and ``BENCHMARK.json`` agrees with them."""

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
    ctx = harness.context(cell_d, config, None, 0)
    program, plain = ctx["target"], ctx["plain"]
    assert all(callable(f) for f in (program.density, program.latents,
                                     program.flat))
    assert all(callable(f) for f in (plain.density, plain.scale, plain.cost))
    assert plain.dim(config) == config["dim"]
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


NEW_TARGET = os.path.join(harness.BENCH_DIR, "tests", "new_target")

# Run in the copy: the new configuration's cell through its jobs and its
# check on the CPU, the reference in bfloat16 put in the program's place
# and checked, then every per-layer reader over a made-up trace of the
# run, one K1 launch an iteration. The cell's limits were set from 14
# seeds (largest step_size_gap 1.5e-3, mass_gap 7.8e-3, draws_off 0,
# ess_gap 8.4e-8) and 4 bfloat16 controls (least 0.060, 0.34, 1, 1.5e-6).
PROOF = """
import json, os, sys
import torch
from benchmark import harness, program_spans, tracing
for n in harness.names("reference/targets", ".py"):
    harness.module("reference/targets", n)
assert "zhusuan_tpu_torch" not in {m.split(".")[0] for m in sys.modules}
from benchmark.metrics import _common, step_mfu
from benchmark.tests import cpu_run
cell, config = harness.load_cell("hmc.linreg8d.cpu")
jobs, kept, numbers, correct = cpu_run.run(cell, config, 2 ** 35 + 11)
reference = harness.module("reference", "hmc")
control = reference.check(reference.stand_in(kept[1], cell, config,
                                             torch.bfloat16), cell, config)
control_correct, _ = harness.judge(control, cell["limits"])
iters = cell["n_warmup"] + cell["n_sample"]
events = [{"ph": "X", "cat": "user_annotation", "name": "bench.job",
           "ts": 0, "dur": 20 * iters + 10}]
events += [{"ph": "X", "cat": "kernel", "ts": 20 * i + 5, "dur": 10,
            "name": "void hmc_family_kernel<4, float, D, 0>(Args)"}
           for i in range(iters)]
path = program_spans.trace_path(cell["name"])
os.makedirs(os.path.dirname(path), exist_ok=True)
with open(path, "w") as f:
    json.dump({"traceEvents": events}, f)
jobs[0]["profiled"] = True
ctx = harness.context(cell, config, None, 0)
run = tracing.TracedRun(ctx, jobs, 1.0, path)
metrics, _, _ = run.per_layer(harness.metric_modules())
print(json.dumps({"correct": correct, "numbers": numbers,
                  "control_correct": control_correct, "control": control,
                  "has_loc_or_std": bool({"loc", "std"} & set(config)),
                  "share": _common.kernel_share(run, "hmc_step"),
                  "mfu": step_mfu.read(run), "metrics": sorted(metrics)}))
"""


def test_new_target_is_added_as_files_only(tmp_path):
    """A configuration whose target is not a diagonal Gaussian, its two
    target files and an HMC cell on it, added to a copy of the benchmark
    with no file there edited, run correct on the CPU, and the readers
    take their dimension and work from it."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("_out", "_cache",
                                                  "__pycache__",
                                                  "new_target"))
    added = []
    for dirpath, dirs, files in os.walk(NEW_TARGET):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), NEW_TARGET)
            assert not (copy / rel).exists(), rel
            shutil.copyfile(os.path.join(dirpath, name), copy / rel)
            added.append(rel)
    assert sorted(added) == [
        os.path.join("configs", "linreg8d.json"),
        os.path.join("reference", "targets", "linear_regression.py"),
        os.path.join("targets", "linear_regression.py"),
        os.path.join("workloads", "hmc.linreg8d.cpu.json")]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROOF], cwd=tmp_path,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"], got["numbers"]
    assert not got["control_correct"], got["control"]
    assert not got["has_loc_or_std"]
    assert 0 < got["share"] < 100 and 0 < got["mfu"]
    assert {"hmc_step_roofline", "step_mfu"} <= set(got["metrics"])
