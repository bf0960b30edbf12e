"""The check that decides ``correct``, driven on the CPU at a small size:
sound runs come out correct; a run with its timed path broken underneath,
and the reference put in the program's place in bfloat16, do not.

On the CPU the kernel wrappers run their plain versions with the kernels'
own Philox draws (``cpu_run.route_kernels``)."""

import time
import types
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.tests import cpu_run

SMALL = {
    "hmc.neal100d.32k": dict(chains=256, n_warmup=200, n_sample=40),
    "nuts.neal100d.4k": dict(
        chains=32, n_warmup=12, n_sample=8, check_iterations=2,
        args=dict(step_size=0.01, max_tree_depth=6, adapt_step_size=True)),
    "nuts.neal100d.32k": dict(
        chains=64, n_warmup=30, n_sample=10, check_iterations=2,
        args=dict(step_size=0.1, max_tree_depth=6, adapt_step_size=True,
                  adapt_mass=True, mass_collect_iters=10)),
    "chees.neal100d.16k": dict(
        chains=64, n_warmup=20, n_sample=10, check_iterations=2,
        args=dict(step_size=0.01, max_leapfrogs=60)),
}
WRAPPERS = {"hmc": ("zhusuan_tpu_torch.mcmc.hmc", "fused_hmc_step"),
            "nuts": ("zhusuan_tpu_torch.mcmc.nuts", "fused_nuts_transition"),
            "chees": ("zhusuan_tpu_torch.mcmc.chees", "fused_chees_step")}
SEED = 2 ** 35 + 11


def _run(name, seed=SEED):
    cell, config = cpu_run.small_cell(name, **SMALL[name])
    return cpu_run.run(cell, config, seed)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    _, _, numbers, correct = _run(name)
    assert correct, numbers


def _broken(sampler, fault):
    """A kernel wrapper with ``fault`` planted after it."""
    import importlib

    mod_name, fn_name = WRAPPERS[sampler]
    mod = importlib.import_module(mod_name)
    real = getattr(mod, fn_name)

    def wrapper(density, q, *args, **kw):
        out = list(real(density, q, *args, **kw))
        acc = {"hmc": 2, "nuts": 3, "chees": 3}[sampler]
        if fault == "unchanged":
            out[0] = q.clone()
        elif fault == "half_batch":
            half = out[acc].shape[0] // 2
            out[acc] = out[acc].clone()
            out[acc][half:] = out[acc][:half].mean()
        return tuple(out)

    return mock.patch.object(mod, fn_name, wrapper)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_step_is_not_correct(name, fault):
    cell, _ = cpu_run.small_cell(name, **SMALL[name])
    with _broken(cell["sampler"], fault):
        _, _, numbers, correct = _run(name)
    assert not correct, numbers


@pytest.mark.parametrize("name", sorted(SMALL))
def test_altered_answer_is_not_correct(name):
    """The job's answer, its ESS, altered where the check produces it."""
    import zhusuan_tpu_torch.diagnostics as diag

    real = diag.ess_batch_device
    with mock.patch.object(diag, "ess_batch_device",
                           lambda x, *a, **k: real(x, *a, **k) * 1.01):
        _, _, numbers, correct = _run(name)
    assert not correct and numbers["ess_gap"] > 0.005, numbers


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_in_bfloat16_fails(name):
    """The reference in bfloat16 put in the program's place, checked and
    judged as a run's job is."""
    cell, config = cpu_run.small_cell(name, **SMALL[name])
    _, kept, _, _ = cpu_run.run(cell, config, SEED)
    reference = harness.module("reference", cell["sampler"])
    job = reference.stand_in(kept[1], cell, config, torch.bfloat16)
    numbers = reference.check(job, cell, config)
    correct, _ = harness.judge(numbers, cell["limits"])
    assert not correct, numbers


def test_nuts_rebuild_takes_the_programs_step():
    """Where NUTS's trees first grow in the warm-up (iteration 10 here),
    the narrowest scale's leapfrog sits near its stability edge and the
    chains start far out: rebuilt at the worked-out step, 1e-7 off the
    program's float32 step, 2.7% of this seed's chains take other leaves.
    The check rebuilds at the step the program took."""
    from benchmark.reference import nuts

    cell, config = cpu_run.small_cell(
        "nuts.neal100d.32k", chains=512, n_warmup=10, n_sample=2,
        check_iterations=1)
    with mock.patch.object(nuts, "_plan", lambda cell, words: [10]):
        _, _, numbers, _ = cpu_run.run(cell, config, 11, n_jobs=1)
    assert numbers["draws_off"] <= cell["limits"]["draws_off"], numbers


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_whole_run_without_the_card(fault, capsys):
    """``harness.main`` from set-up to the result line, the card's calls
    stood in for: a sound run prints ``correct`` true, a broken one false."""
    name = "hmc.neal100d.32k"
    load = harness.load_cell

    def small(n):
        cell, config = load(n)
        cell.update(SMALL[name])
        return cell, config

    args = types.SimpleNamespace(workload=name, seed=SEED, seconds=1.0,
                                 trace=0)
    patches = [mock.patch.object(harness, "load_cell", small),
               mock.patch.object(torch.cuda, "synchronize", lambda *a: None),
               mock.patch.object(torch.cuda, "max_memory_allocated",
                                 lambda *a: 0),
               mock.patch.object(torch.cuda, "get_device_name",
                                 lambda *a: "cpu"),
               mock.patch.object(torch.cuda, "empty_cache", lambda *a: None)]
    if fault:
        patches.append(_broken("hmc", fault))
    with cpu_run.route_kernels():
        for p in patches:
            p.start()
        try:
            harness.main(args, time.perf_counter(), 0.0,
                         device=torch.device("cpu"))
        finally:
            for p in reversed(patches):
                p.stop()
    import json

    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is (fault is None)
    assert list(line)[-1] == "check"
