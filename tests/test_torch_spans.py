"""The program's spans (``zhusuan_tpu_torch/profiling.py::span``) in the
run loops of HMC, NUTS and ChEES-HMC, on the CPU through the plain
transitions and through the kernel wrappers' plain versions: silent and
free of torch calls while no profiler records, in place and nested as the
run loop nests while one does, and without effect on the draws.
"""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zhusuan_tpu_torch as zt
from zhusuan_tpu_torch import profiling
from zhusuan_tpu_torch.mcmc import chees, hmc, nuts
from zhusuan_tpu_torch.utils import add_name_scope

N_ITERS, N_ADAPT, MASS_COLLECT = 12, 6, 4
KEY = (2 ** 31 + 7, 12345)
SAMPLERS = ("hmc", "nuts", "chees")
ROUTES = ("plain", "kernel")


@contextlib.contextmanager
def _route(route):
    """``kernel``: send every eligible transition to the kernel wrappers,
    which run their plain versions on the CPU."""
    saved = {m: m.use_kernel for m in (hmc, nuts, chees)}
    if route == "kernel":
        for m in saved:
            m.use_kernel = (lambda flag, q, ineligible:
                            bool(flag) and ineligible() is None)
    try:
        yield
    finally:
        for m, f in saved.items():
            m.use_kernel = f


def _run(sampler, route):
    """``(final state, outputs)`` of ``N_ITERS`` iterations, the first
    ``N_ADAPT`` adapting, of 8 chains on a 3-d diagonal Gaussian."""
    dens = zt.DiagonalGaussianLogJoint("x", torch.zeros(3),
                                       torch.tensor([0.1, 0.5, 1.0]))
    q0 = torch.randn(8, 3, generator=torch.Generator().manual_seed(3))
    with _route(route):
        if sampler == "hmc":
            s = zt.HMC(step_size=0.1, n_leapfrogs=3, adapt_step_size=True,
                       adapt_mass=True, mass_collect_iters=MASS_COLLECT)
            state = s.init({"x": q0}, n_chain_dims=1)
        elif sampler == "nuts":
            s = zt.NUTS(step_size=0.1, max_tree_depth=4,
                        adapt_step_size=True, adapt_mass=True,
                        mass_collect_iters=MASS_COLLECT)
            state = s.init({"x": q0}, n_chain_dims=1)
        else:
            s = zt.ChEESHMC(step_size=0.1, max_leapfrogs=20)
            state = s.init({"x": q0})
        return s.run(dens, {}, state, KEY, N_ITERS, n_adapt=N_ADAPT)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _spans(path):
    """``[(name, start, end)]`` of the trace's ``zs.*`` annotations, in
    start order (microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith("zs.")]
    return sorted(out, key=lambda s: s[1])


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _traced_run(sampler, route, path):
    """:func:`_run` under a CPU profiler, its chrome trace at ``path``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(sampler, route)
    prof.export_chrome_trace(str(path))
    return out


def test_span_off_is_one_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("zs.a"), profiling.span("zs.b")
    assert a is b
    with a as entered:
        assert entered is a


def test_span_on_is_a_record_function(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("zs.outer"):
            with profiling.span("zs.inner"):
                torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    spans = _spans(tmp_path / "t.json")
    assert [s[0] for s in spans] == ["zs.outer", "zs.inner"]
    assert _inside(spans[1], spans[:1])
    assert profiling.span("zs.after") is profiling.span("zs.other")


def test_add_name_scope_goes_through_span(monkeypatch, tmp_path):
    @add_name_scope
    def probe_fn(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert int(probe_fn(torch.tensor(1))) == 2
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "probe_fn" in names

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert int(probe_fn(torch.tensor(2))) == 3
    assert probe_fn.__name__ == "probe_fn"


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_runs_call_no_record_function_off(monkeypatch, sampler, route):
    """With no profiler recording, no span reaches torch's profiler."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    state, out = _run(sampler, route)
    assert state.t == N_ITERS
    assert out["samples"]["x"].shape == (N_ITERS, 8, 3)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_spans_in_the_trace(monkeypatch, tmp_path, sampler, route):
    # Each trial of HMC's step-size search computes one acceptance rate.
    trials, acceptance = [], hmc.get_acceptance_rate

    def counted(*args, **kwargs):
        trials.append(1)
        return acceptance(*args, **kwargs)

    monkeypatch.setattr(hmc, "get_acceptance_rate", counted)
    _traced_run(sampler, route, tmp_path / "t.json")
    spans = _spans(tmp_path / "t.json")

    def named(name):
        return [s for s in spans if s[0] == name]

    iters = named("zs.iter")
    assert len(iters) == N_ITERS
    assert len(named("zs.collect")) == N_ITERS
    assert not any(_inside(c, iters) for c in named("zs.collect"))
    transitions = named("zs.transition")
    assert len(transitions) == N_ITERS
    assert all(_inside(t, iters) for t in transitions)
    # Adaptation: once an adapting iteration, never after.
    adapting = iters[:N_ADAPT]
    adapt_names = {"hmc": ("zs.adapt.step_size", "zs.adapt.mass"),
                   "nuts": ("zs.adapt.step_size", "zs.adapt.mass"),
                   "chees": ("zs.adapt.step_size", "zs.adapt.trajectory")}
    for name in adapt_names[sampler]:
        found = named(name)
        assert len(found) == N_ADAPT, name
        assert all(_inside(s, adapting) for s in found), name
        assert not any(_inside(s, transitions) for s in found), name
    assert {s[0] for s in spans if s[0].startswith("zs.adapt.")} == set(
        adapt_names[sampler])
    # The step-size search (t == 1 and t == mass_collect_iters): one read
    # a trial, inside its search.
    searches = named("zs.init_search")
    reads = named("zs.sync.init_search")
    if sampler == "hmc":
        assert len(searches) == 2
        assert len(reads) == len(trials) >= 2
        assert all(_inside(r, searches) for r in reads)
        assert all(_inside(s, iters[:MASS_COLLECT]) for s in searches)
    else:
        assert searches == reads == []
    syncs = [s for s in spans if s[0].startswith("zs.sync.")]
    assert all(_inside(s, iters) for s in syncs)
    if sampler == "chees":
        jitters = named("zs.chees.jitter")
        assert len(jitters) == N_ITERS
        assert all(_inside(j, transitions) for j in jitters)
        leapfrog_reads = named("zs.sync.chees_leapfrogs")
        assert len(leapfrog_reads) == (N_ITERS if route == "plain" else 0)
    if sampler == "nuts":
        assert all(_inside(s, transitions)
                   for s in named("zs.sync.nuts_tree"))
    # The kernels run only on the card: no launch on the CPU.
    assert named("zs.launch") == []


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_tracing_leaves_the_draws(tmp_path, sampler, route):
    """The draws, the collected outputs and the final state are the same
    to the bit with a profiler recording and without."""
    state_off, out_off = _run(sampler, route)
    state_on, out_on = _traced_run(sampler, route, tmp_path / "t.json")
    assert state_on.t == state_off.t == N_ITERS
    a, b = _leaves(tuple(state_off)), _leaves(tuple(state_on))
    a += _leaves(out_off)
    b += _leaves(out_on)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y
