"""Parity tests of zhusuan_tpu_torch's ChEES slice (mcmc/chees.py,
ops/chees_step.py) against the JAX package, on the CPU in float64.

The JAX scan path draws its momentum and MH uniform from
``split(key) -> key_p, key_u`` (``mcmc/chees.py:300-317``);
:func:`_jax_noise` makes the same draws and the port takes them through
its ``noise=`` hooks. The Pallas kernel draws from the TPU's hardware PRNG
and has no CPU lowering, so the JAX side is the scan path it is held to;
the CUDA kernel itself is checked against its plain version on the card
(``cuda``-marked tests here, and ``chip_smoke.py``).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu_torch
from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu.mcmc.chees import ChEESHMC as JChEES
from zhusuan_tpu.mcmc.chees import ChEESState as JChEESState
from zhusuan_tpu.mcmc.chees import _halton2 as j_halton2
from zhusuan_tpu_torch.mcmc import base as tbase
from zhusuan_tpu_torch.mcmc.chees import ChEESHMC as TChEES
from zhusuan_tpu_torch.mcmc.chees import (
    ChEESState,
    _halton2,
    state_from_numpy,
    state_to_numpy,
)
from zhusuan_tpu_torch.ops import _random
from zhusuan_tpu_torch.ops.chees_step import (
    MAX_DIM,
    chees_step_supported,
    fused_chees_step,
    fused_chees_step_reference,
)
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)

torch.set_num_threads(1)

C, D, RHO = 64, 8, 0.95
TOL = 1e-12  # float64 on both sides; only the order of row sums differs


def _t(x):
    return torch.as_tensor(np.array(x))


def _equi(d=D, rho=RHO):
    """The bench closure (bench.py:307-313) and the port's built-in."""
    a_c = float(1.0 / (1.0 - rho))
    b_c = float(rho / ((1.0 - rho) * (1.0 + (d - 1) * rho)))

    def log_joint(obs):
        z = obs["z"]
        return -0.5 * (a_c * jnp.sum(z * z, -1) - b_c * jnp.sum(z, -1) ** 2)

    return log_joint, EquicorrelatedGaussianLogJoint("z", d, rho)


def _jax_noise(key, shape):
    """The scan path's draws: ``p`` from ``key_p`` (unit mass) and the MH
    uniforms from ``key_u``, as numpy float64."""
    key_p, key_u = jax.random.split(key)
    p = jbase.tree_random_momentum(key_p, {"z": jnp.zeros(shape)},
                                   {"z": jnp.ones((1,) + shape[1:])})["z"]
    u = jax.random.uniform(key_u, shape[:1], jnp.float64)
    return np.asarray(p), np.asarray(u)


def _close(got, want, tol):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], tol)
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# (a) the pieces: Halton jitter, the ChEES gradient
# --------------------------------------------------------------------- #
def test_halton2_matches_jax_exactly():
    ts = list(range(4096)) + [2 ** 16 + 3, 2 ** 30 + 12345, 2 ** 31 - 1,
                              123456789]
    want = np.asarray(jax.vmap(j_halton2)(jnp.asarray(ts, jnp.int32)))
    got = np.asarray([_halton2(t) for t in ts])
    assert want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inf_endpoint", [False, True])
def test_chees_grad_matches_jax(inf_endpoint):
    rs = np.random.RandomState(1)
    q, nq, npp = rs.randn(C, D), rs.randn(C, D), rs.randn(C, D)
    acc = rs.uniform(size=C)
    if inf_endpoint:
        nq[3, 2] = np.inf  # a divergent chain, rejected
        acc[3] = 0.0
    mass = np.ones((1, D))
    jitter = 0.4375
    want = JChEES()._chees_grad(
        {"z": jnp.asarray(q)}, {"z": jnp.asarray(nq)},
        {"z": jnp.asarray(npp)}, {"z": jnp.asarray(mass)}, jnp.asarray(acc),
        jnp.asarray(jitter))
    got = TChEES()._chees_grad({"z": _t(q)}, {"z": _t(nq)}, {"z": _t(npp)},
                               {"z": _t(mass)}, _t(acc), jitter)
    _close(got, want, TOL)
    if inf_endpoint:
        assert float(got) == 0.0
    else:
        assert float(got) != 0.0


# --------------------------------------------------------------------- #
# (b) one transition on JAX's draws, at counts 1, middle and the cap
# --------------------------------------------------------------------- #
def _jax_transition(log_joint, q, p, u, eps, n_steps):
    log_post = jbase.make_log_joint_fn(log_joint, {})

    def grad_fn(qq):
        return jax.grad(lambda v: jnp.sum(log_post(v)))(qq)

    qd, pd = {"z": jnp.asarray(q)}, {"z": jnp.asarray(p)}
    mass = {"z": jnp.ones((1, q.shape[1]))}
    nq, np_ = JChEES()._leapfrog_n(qd, pd, jnp.asarray(eps),
                                   jnp.asarray(n_steps, jnp.int32), grad_fn,
                                   mass)
    _, _, old_lp, new_lp, acc = jbase.get_acceptance_rate_cached(
        qd, pd, nq, np_, log_post, mass, 1, log_post(qd))
    take = jnp.asarray(u) < acc
    out_q = jnp.where(take[:, None], nq["z"], qd["z"])
    sel = jnp.where(take, new_lp, old_lp)
    return [np.asarray(v) for v in
            (out_q, nq["z"], np_["z"], acc, old_lp, sel)]


@pytest.mark.parametrize("density", ["equicorrelated", "diagonal"])
@pytest.mark.parametrize("n_steps", [1, 13, 40])
def test_transition_matches_jax_scan_path(density, n_steps):
    rs = np.random.RandomState(n_steps)
    if density == "equicorrelated":
        jlj, tlj = _equi()
        q = rs.randn(C, D) * 0.5
    else:
        std = np.linspace(0.3, 1.5, D)

        def jlj(obs):
            return jnp.sum(-0.5 * (obs["z"] / std) ** 2, -1)

        tlj = DiagonalGaussianLogJoint(
            "z", torch.zeros(D, dtype=torch.float64), _t(std))
        q = rs.randn(C, D) * std
    p, u = _jax_noise(jax.random.PRNGKey(n_steps), (C, D))
    eps = 0.3  # below the stability limit; both MH decisions occur
    want = _jax_transition(jlj, q, p, u, eps, n_steps)
    got = fused_chees_step_reference(
        tlj, _t(q), torch.ones(1, D, dtype=torch.float64), eps,
        torch.tensor(n_steps, dtype=torch.int32), None, 1,
        noise=(_t(p), _t(u)))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, w, TOL)
    # The sampler's plain transition is the same function.
    log_post = tbase.make_log_joint_fn(tlj, {})
    out = tbase.hmc_transition(
        {"z": _t(q)}, {"z": _t(p)}, _t(u),
        torch.tensor(eps, dtype=torch.float64), n_steps,
        tbase.make_grad_fn(log_post), log_post,
        {"z": torch.ones(1, D, dtype=torch.float64)}, 1,
        log_post({"z": _t(q)}))
    for g, w in zip((out[0]["z"], out[7]["z"], out[8]["z"], out[1]), want):
        _close(g, w, TOL)
    take = u < want[3]
    assert 0 < take.mean() < 1


def test_cpu_wrapper_runs_reference_without_counting():
    _, tlj = _equi()
    q = _t(np.random.RandomState(2).randn(C, D))
    args = (tlj, q, torch.ones(1, D, dtype=torch.float64), 0.1,
            torch.tensor(7, dtype=torch.int32), (3, 4), 5)
    before = fused_chees_step.launches
    got = fused_chees_step(*args)
    want = fused_chees_step_reference(*args)
    assert fused_chees_step.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # Without noise, the plain version draws the kernel's Philox stream.
    eps = _random.philox_normal((3, 4), 5, (C, D), _random.STREAM_MOMENTUM)
    u = _random.philox_uniform((3, 4), 5, (C,), _random.STREAM_MH)
    again = fused_chees_step_reference(*args[:-2], None, 5, noise=(eps, u))
    for g, w in zip(again, want):
        assert torch.equal(g, w)


# --------------------------------------------------------------------- #
# (c) 30 chained ChEESHMC.sample iterations (15 adapting, then frozen)
# --------------------------------------------------------------------- #
def test_chained_sample_matches_jax():
    n_iter, n_adapt = 30, 15
    jlj, tlj = _equi()
    kw = dict(step_size=0.05, trajectory_length=1.0)
    jch, tch = JChEES(**kw), TChEES(**kw)
    q0 = np.random.RandomState(6).randn(C, D)
    jst = jch.init({"z": jnp.asarray(q0)})
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    assert tst.t == 0 and tst.q["z"].dtype == torch.float64
    steps = {a: jax.jit(lambda s, k, a=a: jch.sample(jlj, {}, s, k, adapt=a))
             for a in (True, False)}
    n_leaps = []
    for i in range(n_iter):
        adapt = i < n_adapt
        key = jax.random.PRNGKey(200 + i)
        jst, jinfo = steps[adapt](jst, key)
        p, u = _jax_noise(key, (C, D))
        tst, tinfo = tch.sample(tlj, {}, tst, adapt=adapt,
                                noise=(_t(p), _t(u)))
        assert int(tinfo.n_leapfrogs) == int(jinfo.n_leapfrogs)
        assert tinfo.n_leapfrogs.dtype == torch.int32
        n_leaps.append(int(tinfo.n_leapfrogs))
        _close(tinfo.acceptance_rate, jinfo.acceptance_rate, 1e-8)
        _close(tinfo.log_prob, jinfo.log_prob, 1e-8)
        _close(tinfo.trajectory_length, jinfo.trajectory_length, 1e-8)
    assert tst.t == n_iter
    final = state_to_numpy(tst)
    for name in ChEESState._fields:
        if name != "t":
            _close(getattr(final, name),
                   jax.tree_util.tree_map(np.asarray, getattr(jst, name)),
                   1e-8)
    # The trajectory length moved while adapting and the jitter varies L.
    assert len(set(n_leaps)) > 3
    assert float(final.adam_t) == n_adapt
    # The numpy state goes back into the JAX sampler unchanged.
    back = JChEESState(*[jax.tree_util.tree_map(jnp.asarray, v)
                         for v in final])
    _close(back.q["z"], jst.q["z"], 1e-8)


def test_frozen_gate_clips_log_traj_and_holds_step_size():
    """adapt=False keeps exp(log_epsilon_bar) as the step size and still
    clips log T to [log eps, log(eps max_leapfrogs)] (chees.py:369-375)."""
    jlj, tlj = _equi()
    kw = dict(step_size=0.05, trajectory_length=50.0, max_leapfrogs=12)
    jch, tch = JChEES(**kw), TChEES(**kw)
    jst = jch.init({"z": jnp.zeros((C, D))})
    jst = jst._replace(da_step=jnp.asarray(3.0),
                       log_epsilon_bar=jnp.asarray(np.log(0.07)),
                       adam_m=jnp.asarray(0.3), adam_v=jnp.asarray(0.2),
                       adam_t=jnp.asarray(3.0))
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    key = jax.random.PRNGKey(9)
    jnew, jinfo = jch.sample(jlj, {}, jst, key, adapt=False)
    p, u = _jax_noise(key, (C, D))
    tnew, tinfo = tch.sample(tlj, {}, tst, adapt=False, noise=(_t(p), _t(u)))
    # At the cap: the trajectory (50) is far beyond 12 steps of 0.05; the
    # transition there matches at 1e-12.
    assert int(tinfo.n_leapfrogs) == int(jinfo.n_leapfrogs) == 12
    for name in ("acceptance_rate", "log_prob", "samples"):
        _close(getattr(tinfo, name), jax.tree_util.tree_map(
            np.asarray, getattr(jinfo, name)), TOL)
    _close(tnew.step_size, 0.07, 1e-12)
    _close(tnew.log_traj, np.log(0.07 * 12), 1e-12)
    for name in ("adam_m", "adam_v", "adam_t", "da_step", "h_bar"):
        assert float(getattr(tnew, name)) == float(getattr(tst, name))
    final = state_to_numpy(tnew)
    for name in ChEESState._fields:
        if name != "t":
            _close(getattr(final, name),
                   jax.tree_util.tree_map(np.asarray, getattr(jnew, name)),
                   1e-10)


def test_gate_tensor_matches_python_bool():
    _, tlj = _equi()
    tch = TChEES(step_size=0.05)
    st = tch.init({"z": torch.zeros(C, D, dtype=torch.float64)})
    st, _ = tch.sample(tlj, {}, st, (1, 2))
    for flag in (True, False):
        a, ia = tch.sample(tlj, {}, st, (3, 4), adapt=flag)
        b, ib = tch.sample(tlj, {}, st, (3, 4), adapt=torch.tensor(flag))
        for name in ChEESState._fields:
            if name not in ("q", "t"):
                torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                           rtol=0, atol=0)
        assert torch.equal(a.q["z"], b.q["z"])


# --------------------------------------------------------------------- #
# (d) run, divergences, statistics
# --------------------------------------------------------------------- #
def test_run_collects_four_fields_and_freezes_after_n_adapt():
    _, tlj = _equi(d=4)
    tch = TChEES(step_size=0.05, trajectory_length=0.5)
    st = tch.init({"z": torch.zeros(16, 4)})
    final, out = tch.run(tlj, {}, st, torch.Generator().manual_seed(0), 40,
                         n_adapt=25)
    assert final.t == 40
    assert set(out) == {"samples", "acceptance_rate", "trajectory_length",
                        "n_leapfrogs"}
    assert out["samples"]["z"].shape == (40, 16, 4)
    assert out["samples"]["z"].dtype == torch.float32
    assert out["acceptance_rate"].shape == (40, 16)
    assert out["trajectory_length"].shape == (40,)
    assert out["n_leapfrogs"].shape == (40,)
    assert out["n_leapfrogs"].dtype == torch.int32
    traj = out["trajectory_length"]
    assert torch.all(traj[25:] == traj[25])
    assert len(set(out["n_leapfrogs"][25:].tolist())) > 1
    assert torch.equal(out["samples"]["z"][-1], final.q["z"])
    again, none = tch.run(tlj, {}, st, torch.Generator().manual_seed(0), 40,
                          n_adapt=25, collect=False)
    assert none is None and torch.equal(again.q["z"], final.q["z"])


def test_run_carries_the_density_value_on_the_plain_path():
    """A user closure: one density evaluation up front, then per
    iteration only the proposal's (the cache carries the kept one)."""
    calls = []

    def log_joint(obs):
        calls.append(1)
        return -0.5 * (obs["z"] ** 2).sum(-1)

    tch = TChEES(step_size=0.3, trajectory_length=0.6)
    st = tch.init({"z": torch.zeros(8, 3)})
    _, out = tch.run(log_joint, {}, st, (1, 2), 5)
    # 1 (the cache) + per iteration n_steps + 1 gradients and the
    # proposal's density.
    assert len(calls) == 1 + int(out["n_leapfrogs"].sum()) + 2 * 5


def test_divergence_does_not_poison_adaptation():
    """JAX's own setting (tests/test_chees.py:83-102): a quartic density
    and a step past stability; divergences contribute zero gradient."""
    def lj(obs):
        return -0.5 * torch.sum(obs["z"] ** 4, -1)

    s = TChEES(step_size=0.9, trajectory_length=20.0)
    st = s.init({"z": torch.full((32, 4), 3.0)})
    final, out = s.run(lj, {}, st, torch.Generator().manual_seed(5), 200,
                       n_adapt=200)
    assert torch.isfinite(out["trajectory_length"]).all()
    assert torch.isfinite(final.log_traj)
    assert torch.isfinite(final.q["z"]).all()
    late_acc = float(out["acceptance_rate"][-50:].mean())
    assert late_acc > 0.3, late_acc


def test_run_statistics_on_the_equicorrelated_target():
    c, d = 256, 4
    _, tlj = _equi(d=d, rho=0.5)
    tch = TChEES(step_size=0.1, trajectory_length=1.0)
    st = tch.init({"z": torch.zeros(c, d, dtype=torch.float64)})
    _, out = tch.run(tlj, {}, st, torch.Generator().manual_seed(3), 400,
                     n_adapt=200)
    xs = out["samples"]["z"][200:].reshape(-1, d)
    cov = torch.cov(xs.T)
    want = 0.5 * torch.ones(d, d, dtype=torch.float64) + 0.5 * torch.eye(
        d, dtype=torch.float64)
    assert float((cov - want).abs().max()) < 0.1
    a = out["acceptance_rate"][200:]
    harm = float((1.0 / (1.0 / a.clamp(min=1e-10)).mean(1)).mean())
    assert abs(harm - 0.651) < 0.1, harm


# --------------------------------------------------------------------- #
# (e) contracts, gates, dtypes
# --------------------------------------------------------------------- #
def test_constructor_init_and_chain_rank():
    with pytest.raises(ValueError):
        TChEES(experimental_fused_step="sometimes")
    tch = TChEES(step_size=0.2, trajectory_length=3.0)
    st = tch.init({"z": torch.zeros(4, 3)})
    assert st.t == 0 and st.step_size.dtype == torch.float32
    assert float(st.log_traj) == pytest.approx(np.log(3.0))
    assert tch.mu == pytest.approx(np.log(2.0))
    st2 = tch.init({"z": torch.zeros(2, 3, 4)})
    with pytest.raises(ValueError, match="one chain axis"):
        tch.sample(lambda obs: obs["z"].sum(-1), {}, st2, (1, 2))


def test_adaptation_stays_in_the_state_dtype():
    """A float64 density over a float32 state must not promote the
    adaptation scalars (JAX fix de43ee6)."""
    def lj(obs):
        return -0.5 * (obs["z"].double() ** 2).sum(-1)

    tch = TChEES(step_size=0.1)
    st = tch.init({"z": torch.zeros(8, 3)})
    st, info = tch.sample(lj, {}, st, (1, 2))
    for name in ChEESState._fields:
        if name not in ("q", "t"):
            assert getattr(st, name).dtype == torch.float32, name
    assert info.acceptance_rate.dtype == torch.float32


@pytest.mark.parametrize("shape,dtype,ok", [
    ((4096, 100), torch.float32, True),
    ((1000, 37), None, True),
    ((8, MAX_DIM), torch.float32, True),
    ((8, MAX_DIM + 1), torch.float32, False),
    ((8,), torch.float32, False),
    ((8, 8), torch.bfloat16, False),
    ((8, 8), torch.float64, False),
])
def test_chees_step_supported(shape, dtype, ok):
    assert chees_step_supported(shape, dtype) is ok


def test_kernel_gate_takes_both_builtins_and_explains():
    ok = TChEES._fused_ineligible
    q = {"z": torch.zeros(8, 4)}
    m = {"z": torch.ones(1, 4)}
    diag = DiagonalGaussianLogJoint("z", torch.zeros(4), torch.ones(4))
    equi = EquicorrelatedGaussianLogJoint("z", 4, 0.9)
    assert ok(diag, {}, q, m, 1) is None
    assert ok(equi, {}, q, m, 1) is None
    assert "built-in" in ok(lambda o: o["z"].sum(-1), {}, q, m, 1)
    assert "float32" in ok(equi, {}, {"z": q["z"].double()},
                           {"z": m["z"].double()}, 1)
    assert "dim" in ok(EquicorrelatedGaussianLogJoint("z", 5, 0.9), {}, q, m,
                       1)
    # On the CPU even experimental_fused_step=True takes the plain path.
    tch = TChEES(step_size=0.1, experimental_fused_step=True)
    st = tch.init({"z": torch.zeros(8, 4)})
    before = fused_chees_step.launches
    st, info = tch.sample(lambda o: -0.5 * (o["z"] ** 2).sum(-1), {}, st,
                          (1, 2))
    assert st.t == 1 and fused_chees_step.launches == before


def test_wrapper_refuses():
    _, tlj = _equi()
    q = torch.zeros(C, D)
    n = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_chees_step(lambda o: o, q, torch.ones(1, D), 0.1, n, (1, 2), 1)
    with pytest.raises(ValueError):
        fused_chees_step(tlj, q, torch.ones(C, D), 0.1, n, (1, 2), 1)
    with pytest.raises(TypeError):
        fused_chees_step(tlj, q, torch.ones(1, D), 0.1, 3, (1, 2), 1)
    with pytest.raises(ValueError):
        fused_chees_step(tlj, q, torch.ones(1, D), 0.1, n, (1, 2), 1,
                         noise=(torch.zeros(C, D + 1), torch.zeros(C)))


# --------------------------------------------------------------------- #
# (f) the slices' modules never import jax (the package-wide scan is in
# tests/test_torch_hmc.py; this names the ChEES and SGMCMC slices' files)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rel", [
    "mcmc/chees.py", "mcmc/precondition.py", "ops/chees_step.py",
    "ops/leapfrog.py", "ops/densities.py", "mcmc/sgmcmc.py",
    "ops/sgld_step.py", "ops/psgld_step.py", "ops/sghmc_step.py",
    "ops/sgnht_step.py"])
def test_slice_modules_never_import_jax(rel):
    path = os.path.join(os.path.dirname(zhusuan_tpu_torch.__file__), rel)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names, path
    assert not [n for n in names if n.split(".")[0] in ("jax",
                                                          "zhusuan_tpu")]


# --------------------------------------------------------------------- #
# On the card only: the CUDA kernel against its plain version.
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("density", ["equicorrelated", "diagonal"])
def test_kernel_matches_reference_on_card(density):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    rs = np.random.RandomState(4)
    if density == "equicorrelated":
        dens = EquicorrelatedGaussianLogJoint("z", D, RHO)
    else:
        dens = DiagonalGaussianLogJoint("z", torch.zeros(D, device=dev),
                                        torch.linspace(0.3, 1.0, D,
                                                       device=dev))
    q = torch.as_tensor(rs.randn(C, D), dtype=torch.float32, device=dev)
    mass = torch.ones(1, D, device=dev)
    noise = (torch.as_tensor(rs.randn(C, D), dtype=torch.float32,
                             device=dev),
             torch.as_tensor(rs.uniform(size=C), dtype=torch.float32,
                             device=dev))
    n = torch.tensor(9, dtype=torch.int32, device=dev)
    before = fused_chees_step.launches
    got = fused_chees_step(dens, q, mass, 0.1, n, (1, 2), 1, noise=noise)
    torch.cuda.synchronize()
    assert fused_chees_step.launches == before + 1
    want = fused_chees_step_reference(dens, q, mass, 0.1, n, (1, 2), 1,
                                      noise=noise)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_true_raises_on_ineligible_cuda_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    tch = TChEES(step_size=0.1, experimental_fused_step=True)
    st = tch.init({"z": torch.zeros(16, 4, device="cuda")})
    with pytest.raises(ValueError):
        tch.sample(lambda obs: -0.5 * (obs["z"] ** 2).sum(-1), {}, st, (1, 2))
