"""Parity of the port's annealed SMC (``zhusuan_tpu_torch/smc.py``) with
``zhusuan_tpu/smc.py`` in float64 on the CPU, on the JAX draws.

JAX's ``run`` splits ``key_init, key_scan, key_final = split(key, 3)``
(``run_adaptive``: ``key_init, key_loop, key_last, key_final = split(key,
4)``, the closing jump on ``key_last``); the initial particles are
``proposal.observe(key_init)``; temperature ``i`` takes ``k, sub =
split(k)`` and ``_bridge_step(sub)`` splits ``k_res, k_moves``: the
resampling uniform ``uniform(k_res, (), f64)`` and ``split(k_moves,
n_moves)``, each move's kernel draws (MALA: ``key_prop, key_mh =
split(kk)``, the proposal normals ``tree_normal_like(key_prop, q)`` and the
MH uniforms; HMC: ``key_p, key_u, key_j = split(kk, 3)``, the momentum
``tree_normal_like(key_p, q)`` and the MH uniforms). The port takes them
all through ``noise=``; the final resample takes ``uniform(key_final, (),
f64)``. Held at 1e-10: ``_systematic_resample``, one bridge step and a
whole ``run`` with MALA and with HMC, ``run_adaptive`` ending by itself
and forced to its closing jump; the validation errors against JAX's
messages; the port's own draws (two runs on one key agree). The port's
built-in bridge (``prior_density=``, the route that takes the HMC kernel
on the card) is held to JAX's closure the same way."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu.mcmc import HMC as JHMC
from zhusuan_tpu.mcmc import MALA as JMALA
from zhusuan_tpu.mcmc import RandomWalkMetropolis as JRWM
from zhusuan_tpu.mcmc.base import tree_normal_like as j_tree_normal_like
from zhusuan_tpu.smc import AnnealedSMC as JSMC
from zhusuan_tpu.smc import _systematic_resample as j_resample
from zhusuan_tpu_torch import smc as tsmc
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import HMC, MALA, RandomWalkMetropolis
from zhusuan_tpu_torch.ops.densities import DiagonalGaussianLogJoint

TOL = 1e-10
N = 32
SA, SB, XA, XB = 0.5, 1.0, 0.7, -1.1
N_MOVES = 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def j_lj(obs):
    a, b = obs["a"], obs["b"]
    return (-0.5 * a ** 2 - 0.5 * b ** 2 - 0.5 * ((XA - a) / SA) ** 2
            - 0.5 * ((XB - b) / SB) ** 2)


def t_lj(obs):
    a, b = obs["a"], obs["b"]
    return (-0.5 * a ** 2 - 0.5 * b ** 2 - 0.5 * ((XA - a) / SA) ** 2
            - 0.5 * ((XB - b) / SB) ** 2)


def j_proposal(n=N):
    @zs.meta_bayesian_net()
    def proposal():
        bn = zs.BayesianNet()
        bn.normal("a", jnp.zeros(n), std=jnp.float64(1.0))
        bn.normal("b", jnp.zeros(n), std=jnp.float64(1.0))
        return bn

    return proposal()


def t_proposal(n=N):
    @meta_bayesian_net()
    def proposal():
        bn = BayesianNet()
        one = torch.tensor(1.0, dtype=torch.float64)
        bn.normal("a", torch.zeros(n, dtype=torch.float64), std=one)
        bn.normal("b", torch.zeros(n, dtype=torch.float64), std=one)
        return bn

    return proposal()


KERNELS = {
    "mala": (lambda: JMALA(step_size=0.5), lambda: MALA(step_size=0.5)),
    "hmc": (lambda: JHMC(step_size=0.3, n_leapfrogs=3),
            lambda: HMC(step_size=0.3, n_leapfrogs=3)),
}


def _pair(kind, **kw):
    jk, tk = KERNELS[kind]
    return (JSMC(j_lj, j_proposal(), jk(), observed={}, latent=["a", "b"],
                 **kw),
            tsmc.AnnealedSMC(t_lj, t_proposal(), tk(), observed={},
                             latent=["a", "b"], **kw))


def _like(n=N, d=None):
    """The latents: ``a`` and ``b`` ``[n]``, or one ``x [n, d]``."""
    if d is not None:
        return {"x": jnp.zeros((n, d))}
    return {"a": jnp.zeros(n), "b": jnp.zeros(n)}


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _bridge_draws(key, kind, n, d=None):
    """``_bridge_step(key)``'s draws: the resampling uniform and each
    move's kernel noise (proposal / momentum normals, MH uniforms)."""
    k_res, k_moves = jax.random.split(key)
    moves = []
    for kk in jax.random.split(k_moves, N_MOVES):
        if kind == "mala":
            k_n, k_u = jax.random.split(kk)
        else:
            k_n, k_u, _ = jax.random.split(kk, 3)
        moves.append((j_tree_normal_like(k_n, _like(n, d)),
                      jax.random.uniform(k_u, (n,), jnp.float64)))
    return jax.random.uniform(k_res, (), jnp.float64), moves


def _step_noise(key, kind, n=N, d=None):
    """``_bridge_step``'s ``noise``: MALA takes numpy arrays (its ``noise``
    is copied with ``torch.tensor``), HMC tensors."""
    u, moves = _bridge_draws(key, kind, n, d)
    conv = (lambda v: np.array(v)) if kind == "mala" else _t
    return (_t(u), [({k: conv(v) for k, v in xi.items()}, conv(um))
                    for xi, um in moves])


def _init(jsmc, key):
    return {k: _t(v) for k, v in jsmc._init_particles(key).items()}


def test_systematic_resample():
    rng = np.random.default_rng(0)
    for n in (1, 5, 64):
        lw = rng.normal(size=n) * 3.0
        key = jax.random.PRNGKey(n)
        want = j_resample(key, jnp.asarray(lw))
        u = jax.random.uniform(key, (), jnp.float64)
        got = tsmc._systematic_resample(None, _t(lw), _t(u))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        got2 = tsmc._systematic_resample(torch.Generator().manual_seed(1),
                                         _t(lw))
        assert got2.shape == (n,) and int(got2.max()) < n


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_bridge_step(kind):
    jsmc, tsmc_ = _pair(kind, n_temperatures=10, n_moves=N_MOVES,
                        resample_threshold=0.9)
    q = jsmc._init_particles(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    log_w = rng.normal(size=N) * 2.0  # collapsed enough to resample
    key = jax.random.PRNGKey(5)
    beta_prev, beta = 0.2, 0.35
    want = jax.jit(lambda q, lw, k: jsmc._bridge_step(
        q, lw, jnp.float64(0.1), jnp.int32(0), k, jnp.float64(beta_prev),
        jnp.float64(beta), N, jnp.log(jnp.float64(N)), jnp.float64))(
            q, jnp.asarray(log_w), key)
    got = tsmc_._bridge_step(
        {k: _t(v) for k, v in q.items()}, _t(log_w), _t(0.1),
        torch.zeros((), dtype=torch.int32), None, 1, _t(beta_prev),
        _t(beta), noise=_step_noise(key, kind))
    for k in ("a", "b"):
        _close(got[0][k], want[0][k])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    assert int(got[3]) == 1


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_run(kind):
    n_temps = 12
    jsmc, tsmc_ = _pair(kind, n_temperatures=n_temps, n_moves=N_MOVES)
    key = jax.random.PRNGKey(7)
    want = jax.jit(jsmc.run)(key)
    key_init, key_scan, key_final = jax.random.split(key, 3)
    steps, k = [], key_scan
    for _ in range(n_temps):
        k, sub = jax.random.split(k)
        steps.append(_step_noise(sub, kind))
    got = tsmc_.run(noise={
        "init": _init(jsmc, key_init), "steps": steps,
        "final": _t(jax.random.uniform(key_final, (), jnp.float64))})
    for k in ("a", "b"):
        _close(got.particles[k], want.particles[k])
    for f in ("log_z", "ess", "acceptance_rate", "betas"):
        _close(getattr(got, f), getattr(want, f))
    assert int(got.n_resamples) == int(want.n_resamples)
    assert got.n_steps == int(want.n_steps) == n_temps


BRIDGE_D = 3
BRIDGE_LOC = np.array([0.4, -0.2, 0.1])
BRIDGE_STD = np.array([0.5, 0.8, 1.2])


def _bridge_pair(**kw):
    """JAX's SMC on a diagonal-Gaussian closure over one latent ``x [N,
    3]`` from N(0, I), and the port's on the built-in target with the
    proposal's built-in (``prior_density=``)."""
    inv_var = 1.0 / np.square(BRIDGE_STD)

    def j_diag(obs):
        return jnp.sum(-0.5 * jnp.square(obs["x"] - BRIDGE_LOC) * inv_var,
                       -1)

    @zs.meta_bayesian_net()
    def j_prop():
        bn = zs.BayesianNet()
        bn.normal("x", jnp.zeros((N, BRIDGE_D)), std=jnp.float64(1.0),
                  group_ndims=1)
        return bn

    @meta_bayesian_net()
    def t_prop():
        bn = BayesianNet()
        bn.normal("x", torch.zeros(N, BRIDGE_D, dtype=torch.float64),
                  std=torch.tensor(1.0, dtype=torch.float64), group_ndims=1)
        return bn

    target = DiagonalGaussianLogJoint("x", _t(BRIDGE_LOC), _t(BRIDGE_STD))
    prior = DiagonalGaussianLogJoint(
        "x", torch.zeros(BRIDGE_D, dtype=torch.float64),
        torch.ones(BRIDGE_D, dtype=torch.float64))
    jk, tk = KERNELS["hmc"]
    return (JSMC(j_diag, j_prop(), jk(), observed={}, latent=["x"], **kw),
            tsmc.AnnealedSMC(target, t_prop(), tk(), observed={},
                             latent=["x"], prior_density=prior, **kw),
            target, t_prop)


def test_run_on_the_builtin_bridge():
    """``prior_density=`` hands the HMC moves a ``TemperedLogJoint`` (the
    HMC kernel's route on the card); on the CPU its plain transition
    matches JAX's closure at 1e-10 on JAX's draws."""
    n_temps = 12
    jsmc, tsmc_, _, _ = _bridge_pair(n_temperatures=n_temps,
                                     n_moves=N_MOVES)
    key = jax.random.PRNGKey(13)
    want = jax.jit(jsmc.run)(key)
    key_init, key_scan, key_final = jax.random.split(key, 3)
    steps, k = [], key_scan
    for _ in range(n_temps):
        k, sub = jax.random.split(k)
        steps.append(_step_noise(sub, "hmc", N, BRIDGE_D))
    got = tsmc_.run(noise={
        "init": _init(jsmc, key_init), "steps": steps,
        "final": _t(jax.random.uniform(key_final, (), jnp.float64))})
    _close(got.particles["x"], want.particles["x"])
    for f in ("log_z", "ess", "acceptance_rate", "betas"):
        _close(getattr(got, f), getattr(want, f))
    assert int(got.n_resamples) == int(want.n_resamples)
    moved = tsmc_._tempered(torch.tensor(0.3, dtype=torch.float64))
    assert type(moved).__name__ == "TemperedLogJoint"


def test_builtin_bridge_validation():
    _, _, target, t_prop = _bridge_pair()
    hmc = HMC(step_size=0.3, n_leapfrogs=3)
    wide = DiagonalGaussianLogJoint(
        "x", torch.zeros(BRIDGE_D, dtype=torch.float64),
        2.0 * torch.ones(BRIDGE_D, dtype=torch.float64))
    with pytest.raises(ValueError, match="more than a constant"):
        tsmc.AnnealedSMC(target, t_prop(), hmc, {}, ["x"],
                         prior_density=wide).run((0, 1))
    with pytest.raises(TypeError, match="target must be one of"):
        tsmc.AnnealedSMC(lambda obs: obs["x"].sum(-1), t_prop(), hmc, {},
                         ["x"], prior_density=wide)
    with pytest.raises(ValueError, match="single latent 'x'"):
        tsmc.AnnealedSMC(target, t_prop(), hmc, {"y": 1.0}, ["x"],
                         prior_density=wide)


@pytest.mark.parametrize("max_steps", [30, 3])
def test_run_adaptive(max_steps):
    """At 30 steps the ladder reaches beta = 1 by itself; at 3 the
    max-steps limit forces the closing jump."""
    jsmc, tsmc_ = _pair("mala", n_moves=N_MOVES)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda k: jsmc.run_adaptive(
        k, target_cess=0.9, max_steps=max_steps))(key)
    key_init, key_loop, key_last, key_final = jax.random.split(key, 4)
    steps, k = [], key_loop
    for _ in range(max_steps):
        k, sub = jax.random.split(k)
        steps.append(_step_noise(sub, "mala"))
    steps.append(_step_noise(key_last, "mala"))
    got = tsmc_.run_adaptive(target_cess=0.9, max_steps=max_steps, noise={
        "init": _init(jsmc, key_init), "steps": steps,
        "final": _t(jax.random.uniform(key_final, (), jnp.float64))})
    for k in ("a", "b"):
        _close(got.particles[k], want.particles[k])
    for f in ("log_z", "ess", "acceptance_rate", "betas"):
        _close(getattr(got, f), getattr(want, f))
    assert int(got.n_resamples) == int(want.n_resamples)
    assert got.n_steps == int(want.n_steps)
    if max_steps == 3:
        assert got.n_steps == 4  # the closing jump
    else:
        assert 1 < got.n_steps <= max_steps
    _close(got.betas[got.n_steps - 1], 1.0)


def test_own_draws():
    """The port's own draws: the proposal's seed, the resampling uniforms
    and the moves' keys come from one key; two runs agree, the evidence is
    near the closed form."""
    n = 2000
    smc = tsmc.AnnealedSMC(t_lj, t_proposal(n),
                           RandomWalkMetropolis(step_size=0.8), observed={},
                           latent=["a", "b"], n_temperatures=30)
    a = smc.run((1, 2))
    b = smc.run(torch.Generator().manual_seed(3))
    c = smc.run((1, 2))
    assert torch.equal(a.particles["a"], c.particles["a"])
    assert not torch.equal(a.particles["a"], b.particles["a"])
    # log of the integral of exp(t_lj) over (a, b): the target is not
    # normalized, the proposal is.
    true_log_z = sum(0.5 * math.log(2 * math.pi * s ** 2 / (1 + s ** 2))
                     - 0.5 * x ** 2 / (1 + s ** 2)
                     for s, x in ((SA, XA), (SB, XB)))
    for res in (a, b):
        assert abs(float(res.log_z) - true_log_z) < 0.05
    ad = smc.run_adaptive((4, 5))
    assert abs(float(ad.log_z) - true_log_z) < 0.08
    assert int(ad.n_resamples) >= 0 and ad.betas.shape == (201,)


def test_validation_errors():
    def both(fn):
        with pytest.raises(Exception) as je:
            fn(JSMC, JMALA, j_proposal)
        with pytest.raises(type(je.value)) as te:
            fn(tsmc.AnnealedSMC, MALA, t_proposal)
        assert str(te.value) == str(je.value)

    both(lambda S, M, P: S(j_lj, P(), object(), {}, ["a", "b"]))
    for kw in (dict(n_temperatures=0), dict(n_moves=-1),
               dict(resample_threshold=1.5)):
        both(lambda S, M, P: S(j_lj, P(), M(), {}, ["a", "b"], **kw))
    both(lambda S, M, P: S(j_lj, P(), M(), {}, ["a", "b"]).run_adaptive(
        None, target_cess=1.0))

    @zs.meta_bayesian_net()
    def j_wide():
        bn = zs.BayesianNet()
        bn.normal("a", jnp.zeros((4, 3)), std=jnp.float64(1.0))
        return bn

    @meta_bayesian_net()
    def t_wide():
        bn = BayesianNet()
        bn.normal("a", torch.zeros(4, 3, dtype=torch.float64),
                  std=torch.tensor(1.0, dtype=torch.float64))
        return bn

    with pytest.raises(ValueError) as je:
        JSMC(j_lj, j_wide(), JRWM(), {}, ["a"]).run(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as te:
        tsmc.AnnealedSMC(t_lj, t_wide(), RandomWalkMetropolis(), {},
                         ["a"]).run((0, 0))
    assert str(te.value) == str(je.value)


def test_exports_match_the_jax_modules():
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu import smc as jsmc_mod
    from zhusuan_tpu import ssm as jssm_mod
    from zhusuan_tpu_torch import ssm as tssm_mod

    assert tsmc.__all__ == jsmc_mod.__all__
    assert tssm_mod.__all__ == jssm_mod.__all__
    for name in tsmc.__all__ + tssm_mod.__all__:
        assert getattr(zt, name) is getattr(
            tsmc if name in tsmc.__all__ else tssm_mod, name)
        assert name in zt.__all__
