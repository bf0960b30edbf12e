"""Parity tests of zhusuan_tpu_torch's HMC slice (utils, mcmc/base.py,
mcmc/hmc.py) against the JAX package, on the CPU in float64.

Inputs come from ``np.random.RandomState`` and go to both packages; where a
function draws random numbers, the numbers the JAX run drew are fed to the
port through its ``noise`` / ``eps`` hooks.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu.utils as jutils
from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu.mcmc.hmc import HMC as JHMC
from zhusuan_tpu.mcmc.hmc import HMCState as JHMCState
import zhusuan_tpu_torch
import zhusuan_tpu_torch.utils as tutils
from zhusuan_tpu_torch.mcmc import base as tbase
from zhusuan_tpu_torch.mcmc.hmc import (
    HMC as THMC,
    state_from_numpy,
    state_to_numpy,
)
from zhusuan_tpu_torch.ops._random import iteration_generator
from zhusuan_tpu_torch.ops.hmc_step import DiagonalGaussianLogJoint

torch.set_num_threads(1)

TOL = 1e-12
C, D = 64, 8


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


# A two-latent model with an observation: "a" [C, D], "b" [C] (no data
# axes), "y" observed.
def _model_inputs(seed=0):
    rs = np.random.RandomState(seed)
    return dict(
        q={"a": rs.randn(C, D), "b": rs.randn(C)},
        p={"a": rs.randn(C, D), "b": rs.randn(C)},
        mass={"a": rs.uniform(0.5, 2.0, (1, D)), "b": rs.uniform(0.5, 2.0, (1,))},
        w=rs.uniform(0.5, 3.0, D),
        y=rs.randn(3),
    )


def _jax_log_joint(x):
    w = x["w"]

    def log_joint(obs):
        return (jnp.sum(-0.5 * obs["a"] ** 2 * w, -1) - obs["b"] ** 2
                + jnp.sum(obs["y"]) * obs["b"])
    return log_joint


def _torch_log_joint(x):
    w = _t(x["w"])

    def log_joint(obs):
        return (torch.sum(-0.5 * obs["a"] ** 2 * w, -1) - obs["b"] ** 2
                + torch.sum(obs["y"]) * obs["b"])
    return log_joint


def _both(x):
    jq = {k: jnp.asarray(v) for k, v in x["q"].items()}
    tq = {k: _t(v) for k, v in x["q"].items()}
    jlp = jbase.make_log_joint_fn(_jax_log_joint(x), {"y": jnp.asarray(x["y"])})
    tlp = tbase.make_log_joint_fn(_torch_log_joint(x), {"y": _t(x["y"])})
    jgrad = jax.grad(lambda v: jnp.sum(jlp(v)))
    tgrad = tbase.make_grad_fn(tlp)
    return jq, tq, jlp, tlp, jgrad, tgrad


def _tree(x, name, conv):
    return {k: conv(v) for k, v in x[name].items()}


# --------------------------------------------------------------------- #
# (a) utils and mcmc/base.py against their JAX twins
# --------------------------------------------------------------------- #
def test_utils_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(5, 7)
    x[2] = -np.inf
    assert tutils.merge_dicts({"a": 1, "b": 2}, None, {"b": 3}) == \
        jutils.merge_dicts({"a": 1, "b": 2}, None, {"b": 3})
    for axis in (None, 0, 1):
        for keep in (False, True):
            _close(tutils.log_mean_exp(_t(x), axis, keep),
                   jutils.log_mean_exp(jnp.asarray(x), axis, keep))
            y = np.where(np.isinf(x), 0.0, x)
            _close(tutils.log_sum_exp(_t(y), axis, keep),
                   jutils.log_sum_exp(jnp.asarray(y), axis, keep))


def test_log_joint_fn_merges_observed_and_refuses_non_callables():
    x = _model_inputs()
    jq, tq, jlp, tlp, _, _ = _both(x)
    _close(tlp(tq), jlp(jq))
    with pytest.raises(TypeError, match="MetaBayesianNet"):
        tbase.make_log_joint_fn(object(), {})


def test_hamiltonian_pieces_match_jax():
    x = _model_inputs(2)
    jq, tq, jlp, tlp, jgrad, tgrad = _both(x)
    jp, tp = _tree(x, "p", jnp.asarray), _tree(x, "p", _t)
    jm, tm = _tree(x, "mass", jnp.asarray), _tree(x, "mass", _t)
    _close(tbase.tree_velocity(tp, tm), jbase.tree_velocity(jp, jm))
    _close(tbase.kinetic_energy(tq, tp, tm, 1),
           jbase.kinetic_energy(jq, jp, jm, 1))
    _close(tbase.hamiltonian(tq, tp, tlp, tm, 1),
           jbase.hamiltonian(jq, jp, jlp, jm, 1))
    _close(tgrad(tq), jgrad(jq))
    for s1, s2 in ((0.0, 0.05), (0.1, 0.1), (0.1, 0.05)):
        _close(tbase.leapfrog_step(tq, tp, s1, s2, tgrad, tm),
               jbase.leapfrog_step(jq, jp, s1, s2, jgrad, jm))


def test_acceptance_rates_match_jax_with_nonfinite_guard():
    x = _model_inputs(3)
    jq, tq, jlp, tlp, jgrad, tgrad = _both(x)
    jp, tp = _tree(x, "p", jnp.asarray), _tree(x, "p", _t)
    jm, tm = _tree(x, "mass", jnp.asarray), _tree(x, "mass", _t)
    new_q = {k: v + 0.1 for k, v in x["q"].items()}
    new_q["a"][0, 0] = np.nan
    new_q["a"][1, 0] = np.inf
    new_p = {k: 0.9 * v for k, v in x["p"].items()}
    jnq = {k: jnp.asarray(v) for k, v in new_q.items()}
    tnq = {k: _t(v) for k, v in new_q.items()}
    jnp_ = {k: jnp.asarray(v) for k, v in new_p.items()}
    tnp_ = {k: _t(v) for k, v in new_p.items()}
    want = jbase.get_acceptance_rate(jq, jp, jnq, jnp_, jlp, jm, 1)
    got = tbase.get_acceptance_rate(tq, tp, tnq, tnp_, tlp, tm, 1)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[-1][0] == 0.0 and got[-1][1] == 0.0
    want_c = jbase.get_acceptance_rate_cached(jq, jp, jnq, jnp_, jlp, jm, 1,
                                              jlp(jq))
    got_c = tbase.get_acceptance_rate_cached(tq, tp, tnq, tnp_, tlp, tm, 1,
                                             tlp(tq))
    for g, w in zip(got_c, want_c):
        _close(g, w)


def test_tree_random_momentum_with_the_jax_normals():
    x = _model_inputs(4)
    jq, tq = _tree(x, "q", jnp.asarray), _tree(x, "q", _t)
    jm, tm = _tree(x, "mass", jnp.asarray), _tree(x, "mass", _t)
    key = jax.random.PRNGKey(11)
    want = jbase.tree_random_momentum(key, jq, jm)
    # Rebuild the normals exactly as tree_random_momentum draws them.
    names = sorted(jq)
    keys = jax.random.split(key, len(names))
    eps = {n: _t(jax.random.normal(k, jq[n].shape, jq[n].dtype))
           for n, k in zip(names, keys)}
    _close(tbase.tree_random_momentum(None, tq, tm, eps), want)
    # Without eps: torch's generator, one draw per latent in sorted-name
    # order, reproducible per (key, iteration).
    p1 = tbase.tree_random_momentum(iteration_generator((1, 2), 3), tq, tm)
    p2 = tbase.tree_random_momentum(iteration_generator((1, 2), 3), tq, tm)
    p3 = tbase.tree_random_momentum(iteration_generator((1, 2), 4), tq, tm)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert not torch.equal(p1["a"], p3["a"])
    assert p1["a"].dtype == torch.float64


@pytest.mark.parametrize("gate", [True, False, "tensor_true", "tensor_false"])
@pytest.mark.parametrize("fresh", [True, False, "tensor_true"])
@pytest.mark.parametrize("da_step", [0.0, 7.0])
def test_dual_averaging_update_matches_jax(gate, fresh, da_step):
    def conv(v, as_torch):
        if isinstance(v, str):
            b = v.endswith("true")
            return torch.tensor(b) if as_torch else jnp.asarray(b)
        return v

    state = dict(da_step=da_step, h_bar=0.03, log_eps_bar=-1.2,
                 step_size=0.3)
    kw = dict(mu=float(np.log(1.0)), target=0.8, gamma=0.05, t0=100.0,
              kappa=0.75)
    want = jbase.dual_averaging_update(
        *[jnp.asarray(v, jnp.float64) for v in state.values()],
        jnp.asarray(0.63), conv(gate, False), conv(fresh, False), **kw)
    got = tbase.dual_averaging_update(
        *[torch.tensor(v, dtype=torch.float64) for v in state.values()],
        torch.tensor(0.63, dtype=torch.float64), conv(gate, True),
        conv(fresh, True), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_dual_averaging_pins_the_state_dtype():
    """A float64 acceptance statistic must not promote float32 tuner state
    (the fault class fixed in zhusuan_tpu/mcmc/base.py:123-127)."""
    state = [torch.tensor(v, dtype=torch.float32) for v in (3.0, 0.1, -1.0,
                                                            0.2)]
    out = tbase.dual_averaging_update(
        *state, torch.tensor(0.7, dtype=torch.float64), True, False,
        mu=0.0, target=0.8, gamma=0.05, t0=100.0, kappa=0.75)
    assert all(v.dtype == torch.float32 for v in out)


@pytest.mark.parametrize("gate", [True, False, "tensor_true", "tensor_false"])
@pytest.mark.parametrize("ewmv_t", [0.0, 5.0])
def test_ewmv_update_matches_jax(gate, ewmv_t):
    rs = np.random.RandomState(5)
    q = {"x": rs.randn(C, D)}
    mean = {"x": 0.1 * rs.randn(1, D)}
    var = {"x": rs.uniform(0.5, 1.5, (1, D))}
    jgate = jnp.asarray(gate.endswith("true")) if isinstance(gate, str) \
        else gate
    tgate = torch.tensor(gate.endswith("true")) if isinstance(gate, str) \
        else gate
    want = jbase.ewmv_update(
        {"x": jnp.asarray(q["x"])}, jnp.asarray(ewmv_t, jnp.float64),
        {"x": jnp.asarray(mean["x"])}, {"x": jnp.asarray(var["x"])},
        jgate, 1, 0.99)
    got = tbase.ewmv_update(
        {"x": _t(q["x"])}, torch.tensor(ewmv_t, dtype=torch.float64),
        {"x": _t(mean["x"])}, {"x": _t(var["x"])}, tgate, 1, 0.99)
    for g, w in zip(got, want):
        _close(g, w)


# --------------------------------------------------------------------- #
# (c) 30 chained adaptive HMC.sample iterations, JAX noise fed to the port
# --------------------------------------------------------------------- #
def test_chained_adaptive_sample_matches_jax():
    n_iter, c, d = 30, C, D
    target_std = np.linspace(0.1, 1.0, d)

    def jlj(obs):
        return jnp.sum(-0.5 * (obs["x"] / target_std) ** 2, -1)

    kw = dict(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
              adapt_mass=True, mass_collect_iters=10)
    jhmc = JHMC(**kw)
    thmc = THMC(**kw)
    tlj = DiagonalGaussianLogJoint("x", torch.zeros(d, dtype=torch.float64),
                                   torch.as_tensor(target_std))
    q0 = np.random.RandomState(6).randn(c, d)
    jst = jhmc.init({"x": jnp.asarray(q0)}, log_joint=jlj)
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    assert tst.t == 0 and tst.q["x"].dtype == torch.float64
    step = jax.jit(lambda s, k: jhmc.sample(jlj, {}, s, k))
    for i in range(n_iter):
        key = jax.random.PRNGKey(100 + i)
        jst_new, info = step(jst, key)
        # mcmc/hmc.py:557,688: p = normal(key_p) * sqrt(mass), u from key_u.
        eps = np.asarray(info.init_momentum["x"]) / np.sqrt(
            np.asarray(jst_new.mass["x"]))
        _, key_u, _ = jax.random.split(key, 3)
        u = np.asarray(jax.random.uniform(key_u, (c,), jnp.float64))
        tst, tinfo = thmc.sample(tlj, {}, tst, noise=(_t(eps), _t(u)))
        _close(tinfo.acceptance_rate, info.acceptance_rate, 1e-8)
        jst = jst_new
    assert tst.t == n_iter
    final = state_to_numpy(tst)
    for name in ("q", "step_size", "mass", "h_bar", "log_epsilon_bar",
                 "da_step", "ewmv_t", "ewmv_var"):
        _close(getattr(final, name), np.asarray(getattr(jst, name))
               if not isinstance(getattr(jst, name), dict)
               else {k: np.asarray(v) for k, v in getattr(jst, name).items()},
               1e-8)
    # The adapted mass is in use (not the unit mass) by the end.
    assert not np.allclose(final.mass["x"], 1.0)
    # The numpy state goes back into the JAX sampler unchanged.
    back = JHMCState(*[jax.tree_util.tree_map(jnp.asarray, v)
                       for v in final])
    _close(back.q["x"], jst.q["x"], 1e-8)


# --------------------------------------------------------------------- #
# (d) HMC.run statistical parity and the collect options
# --------------------------------------------------------------------- #
def test_run_statistics_match_jax():
    c, d, n_iter, n_adapt = 512, 8, 300, 100
    target_std = np.linspace(0.5, 1.5, d)

    def jlj(obs):
        return jnp.sum(-0.5 * (obs["x"] / target_std) ** 2, -1)

    kw = dict(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
              adapt_mass=True, mass_collect_iters=50)
    fields = ("samples", "acceptance_rate")
    jhmc = JHMC(**kw)
    jst = jhmc.init({"x": jnp.zeros((c, d))}, log_joint=jlj)
    _, jout = jax.jit(lambda s, k: jhmc.run(
        jlj, {}, s, k, n_iter, n_adapt=n_adapt, collect_fields=fields))(
        jst, jax.random.PRNGKey(0))
    thmc = THMC(**kw)
    tlj = DiagonalGaussianLogJoint("x", torch.zeros(d, dtype=torch.float64),
                                   torch.as_tensor(target_std))
    tst = thmc.init({"x": torch.zeros(c, d, dtype=torch.float64)},
                    log_joint=tlj)
    tst, tout = thmc.run(tlj, {}, tst, torch.Generator().manual_seed(0),
                         n_iter, n_adapt=n_adapt, collect_fields=fields)
    assert tst.t == n_iter
    js = np.asarray(jout["samples"]["x"])[n_adapt:].reshape(-1, d).std(0)
    ts = tout["samples"]["x"][n_adapt:].reshape(-1, d).std(0).numpy()
    assert np.max(np.abs(ts / js - 1.0)) < 0.05
    assert np.max(np.abs(ts / target_std - 1.0)) < 0.05
    assert np.max(np.abs(js / target_std - 1.0)) < 0.05
    ja = float(np.mean(np.asarray(jout["acceptance_rate"])[n_adapt:]))
    ta = float(tout["acceptance_rate"][n_adapt:].mean())
    assert abs(ja - ta) < 0.05


def test_run_collect_fields_dtype_and_thinning():
    c, d = 16, 3
    hmc = THMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True,
               adapt_mass=True, mass_collect_iters=4)
    lj = DiagonalGaussianLogJoint("x", torch.zeros(d), torch.ones(d))
    st = hmc.init({"x": torch.zeros(c, d)}, log_joint=lj)
    key = (5, 6)
    full_st, full = hmc.run(lj, {}, st, key, 10, n_adapt=5)
    assert set(full) == {"samples", "acceptance_rate", "step_size",
                         "log_prob"}
    assert full["samples"]["x"].shape == (10, c, d)
    assert full["samples"]["x"].dtype == torch.float32
    assert full["acceptance_rate"].shape == (10, c)
    assert full["step_size"].shape == (10,)
    assert full["log_prob"].shape == (10, c)
    thin_st, thin = hmc.run(lj, {}, st, key, 10, n_adapt=5,
                            collect_fields=("samples", "step_size"),
                            collect_dtype=torch.bfloat16, thinning=3)
    assert set(thin) == {"samples", "step_size"}
    assert thin["samples"]["x"].shape == (3, c, d)
    assert thin["samples"]["x"].dtype == torch.bfloat16
    # Same key, same counters: the thinned output is the full trajectory
    # sliced thinning-1::thinning, and the final states agree.
    assert torch.equal(thin["samples"]["x"],
                       full["samples"]["x"][2::3].to(torch.bfloat16))
    assert torch.equal(thin["step_size"], full["step_size"][2::3])
    assert torch.equal(thin_st.q["x"], full_st.q["x"])
    assert thin_st.t == full_st.t == 10
    none_st, none = hmc.run(lj, {}, st, key, 10, n_adapt=5, collect=False)
    assert none is None and torch.equal(none_st.q["x"], full_st.q["x"])
    with pytest.raises(ValueError):
        hmc.run(lj, {}, st, key, 2, collect_fields=("nope",))
    with pytest.raises(ValueError):
        hmc.run(lj, {}, st, key, 2, thinning=0)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_run_carries_the_density_cache_on_the_plain_path(device):
    """A user closure takes the plain path, where run carries (log_prob,
    grad): n_leapfrogs gradient and one density evaluation per iteration,
    after make_cache's two."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    c, d, n_leapfrogs, n_iters = 8, 3, 4, 5
    calls = []

    def log_joint(obs):
        calls.append(1)
        return -0.5 * (obs["x"] ** 2).sum(-1)

    hmc = THMC(step_size=0.3, n_leapfrogs=n_leapfrogs)
    st = hmc.init({"x": torch.zeros(c, d, device=device)}, n_chain_dims=1)
    hmc.run(log_joint, {}, st, (1, 2), n_iters, collect=False)
    assert len(calls) == 2 + n_iters * (n_leapfrogs + 1)


def test_bf16_state_keeps_f32_adaptation():
    c, d = 32, 4
    hmc = THMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True,
               adapt_mass=True, mass_collect_iters=3)
    lj = DiagonalGaussianLogJoint("x", torch.zeros(d), torch.ones(d))
    st = hmc.init({"x": torch.zeros(c, d, dtype=torch.bfloat16)},
                  log_joint=lj)
    assert st.step_size.dtype == torch.float32
    st, out = hmc.run(lj, {}, st, (1, 1), 6, n_adapt=6)
    assert st.q["x"].dtype == torch.bfloat16
    assert st.mass["x"].dtype == st.step_size.dtype == torch.float32
    assert out["samples"]["x"].dtype == torch.float32
    assert torch.isfinite(st.q["x"].float()).all()


def test_constructor_and_init_contracts():
    with pytest.raises(ValueError):
        THMC(adapt_mass=True)
    with pytest.raises(ValueError):
        THMC(experimental_fused_step="sometimes")
    assert THMC(adapt_step_size=True).mass_collect_iters == 0
    hmc = THMC()
    st = hmc.init({"x": torch.zeros(2, 3, 4, dtype=torch.float64)},
                  log_joint=lambda obs: obs["x"].sum((-1, -2)))
    assert st.mass["x"].shape == (1, 3, 4)
    st = hmc.init({"x": torch.zeros(2, 3, 4)}, n_chain_dims=2)
    assert st.mass["x"].shape == (1, 1, 4)
    with pytest.raises(ValueError):
        hmc.init({"x": torch.zeros(2, 3)})


def test_fused_flag_takes_plain_path_on_cpu_and_explains_ineligibility():
    lj = DiagonalGaussianLogJoint("x", torch.zeros(4), torch.ones(4))
    hmc = THMC(step_size=0.2, n_leapfrogs=2, experimental_fused_step=True)
    st = hmc.init({"x": torch.zeros(8, 4)}, log_joint=lj)
    st, info = hmc.sample(lj, {}, st, (1, 2))
    assert st.t == 1 and info.acceptance_rate.shape == (8,)
    q = {"x": torch.zeros(8, 4)}
    m = {"x": torch.ones(1, 4)}
    ok = THMC._fused_ineligible
    assert ok(lj, {}, q, m, 1) is None
    assert "single" in ok(lj, {}, {**q, "y": q["x"]}, m, 1)
    assert "built-in" in ok(lambda o: o["x"].sum(-1), {}, q, m, 1)
    assert "latent" in ok(lj, {"x": 1}, q, m, 1)
    assert "n_chains" in ok(lj, {}, {"x": torch.zeros(8, 4,
                                                      dtype=torch.float64)},
                            m, 1)
    assert "mass" in ok(lj, {}, q, {"x": torch.ones(8, 4)}, 1)


# --------------------------------------------------------------------- #
# (h) the port never imports jax
# --------------------------------------------------------------------- #
def test_port_never_imports_jax():
    """An ast scan, not a runtime check: this environment may import jax
    before any user code runs."""
    root = os.path.dirname(zhusuan_tpu_torch.__file__)
    offenders, n_files, dirs, scanned = [], 0, set(), set()
    for dirpath, _, files in os.walk(root):
        dirs.add(os.path.relpath(dirpath, root))
        for fname in files:
            if not fname.endswith(".py"):
                continue
            n_files += 1
            path = os.path.join(dirpath, fname)
            scanned.add(os.path.relpath(path, root))
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    if n.split(".")[0] in ("jax", "optax", "zhusuan_tpu",
                                           "examples", "baseline_ref"):
                        offenders.append((path, n))
    assert n_files >= 8
    assert {"framework", "distributions", "variational",
            "examples/gaussian_process", "examples/utils"} <= dirs, dirs
    # the model path's modules and the example files they unblocked
    assert {"framework/marginalize.py", "framework/predictive.py",
            "examples/toy_examples/gaussian.py",
            "examples/variational_autoencoders/bernoulli_latent_vae.py",
            "examples/variational_autoencoders/gumbel_softmax_vae.py",
            "examples/variational_autoencoders/vae_conv.py",
            "examples/bayesian_neural_nets/variational_dropout.py",
            "examples/acceptance.py"} <= scanned, scanned
    # the GP / flow / SVGD / ESS slice and its eight examples
    assert {"gp.py", "transform.py", "distributions/flow.py",
            "mcmc/neutra.py", "mcmc/elliptical.py", "variational/svgd.py",
            "examples/gaussian_process/gp_regression_diabetes.py",
            "examples/gaussian_process/gp_classification_ess.py",
            "examples/normalizing_flows/toy2d_flow.py",
            "examples/normalizing_flows/vae_nf.py",
            "examples/stein_variational/blr_svgd.py",
            "examples/toy_examples/neal_funnel_neutra.py",
            "examples/toy_examples/gaussian_chees.py",
            "examples/toy_examples/mixture_sgnht.py"} <= scanned, scanned
    assert not offenders, offenders
