"""Parity tests of zhusuan_tpu_torch's SGMCMC samplers (mcmc/sgmcmc.py)
against the JAX package, on the CPU in float64.

The JAX samplers draw from ``jax.random``; the port takes the same draws
through its ``noise=`` hooks. :func:`_jax_noise` rebuilds them from the key
a JAX ``sample`` call gets: SGLD and PSGLD draw ``tree_normal_like(key)``;
SGHMC and SGNHT split ``key_r, key_n`` and draw the resampled momentum from
``key_r`` and the integrator noise from ``key_n``
(``zhusuan_tpu/mcmc/sgmcmc.py:98-112, 411-421``); ``run`` splits
``k, sub`` every iteration and samples with ``sub``; ``init`` draws the
momentum ``sqrt(lr(0)) tree_normal_like(key)``. The Pallas kernels draw
from the TPU's hardware PRNG and have no CPU lowering, so the JAX side is
the scan path; the CUDA kernels are held to their plain versions on the
card (``tests/test_torch_ops_sgmcmc_step.py``'s ``cuda`` tests and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu_torch.mcmc import sgmcmc as tsg
from zhusuan_tpu_torch.mcmc.sgmcmc import SGMCMCState
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)

torch.set_num_threads(1)

C, D, RHO = 64, 8, 0.9
STD = np.linspace(0.3, 1.5, D)
LOC = np.linspace(-0.2, 0.2, D)
TOL_ONE = 1e-12  # one step, float64 on both sides
TOL_CHAIN = 1e-8  # 30 chained steps


def _t(x):
    return torch.as_tensor(np.array(x))


# --------------------------------------------------------------------- #
# Targets: both built-ins and a plain callable, in both packages.
# --------------------------------------------------------------------- #
def _target(kind):
    """``(jax log_joint, torch log_joint)`` over the latent "x"."""
    if kind == "diagonal":
        inv_var = 1.0 / STD ** 2

        def jlj(obs):
            return jnp.sum(-0.5 * (obs["x"] - LOC) ** 2 * inv_var, -1)

        return jlj, DiagonalGaussianLogJoint("x", _t(LOC), _t(STD))
    if kind == "equicorrelated":
        a_c = float(1.0 / (1.0 - RHO))
        b_c = float(RHO / ((1.0 - RHO) * (1.0 + (D - 1) * RHO)))

        def jlj(obs):
            z = obs["x"]
            return -0.5 * (a_c * jnp.sum(z * z, -1)
                           - b_c * jnp.sum(z, -1) ** 2)

        return jlj, EquicorrelatedGaussianLogJoint("x", D, RHO)

    # The double well exp(2x^2 - x^4) of tests/test_mcmc.py:25, per chain.
    def jlj(obs):
        x = obs["x"]
        return jnp.sum(2 * x ** 2 - x ** 4, -1)

    def tlj(obs):
        x = obs["x"]
        return torch.sum(2 * x ** 2 - x ** 4, -1)

    return jlj, tlj


TARGETS = ["diagonal", "equicorrelated", "double_well"]

# (name, constructor kwargs shared by both packages)
SAMPLERS = [
    ("SGLD", dict(learning_rate=0.01)),
    ("PSGLD", dict(learning_rate=0.005, epsilon=0.1)),
    ("SGHMC", dict(learning_rate=0.01, friction=0.3, variance_estimate=0.02,
                   n_iter_resample_v=7, second_order=False)),
    ("SGHMC", dict(learning_rate=0.01, friction=0.3, variance_estimate=0.02,
                   n_iter_resample_v=7, second_order=True)),
    ("SGNHT", dict(learning_rate=0.01, variance_extra=0.1,
                   n_iter_resample_v=7, second_order=False,
                   use_vector_alpha=True)),
    ("SGNHT", dict(learning_rate=0.01, variance_extra=0.1,
                   n_iter_resample_v=7, second_order=True,
                   use_vector_alpha=True)),
    ("SGNHT", dict(learning_rate=0.01, variance_extra=0.1,
                   second_order=False, use_vector_alpha=False)),
    ("SGNHT", dict(learning_rate=0.01, variance_extra=0.1,
                   n_iter_resample_v=7, second_order=True,
                   use_vector_alpha=False)),
]
SAMPLER_IDS = ["{}-{}".format(n, "-".join(
    "{}={}".format(k[:6], v) for k, v in kw.items()
    if k in ("second_order", "use_vector_alpha"))) for n, kw in SAMPLERS]


def _pair(name, kw):
    return getattr(zs, name)(**kw), getattr(tsg, name)(**kw)


def _momentum(name):
    return name in ("SGHMC", "SGNHT")


def _jax_noise(name, key, q, resample):
    """The draws a JAX ``sample`` call makes from ``key``, as numpy."""
    like = {"x": jnp.asarray(q)}
    if not _momentum(name):
        return np.asarray(jbase.tree_normal_like(key, like)["x"])
    key_r, key_n = jax.random.split(key)
    eps = np.asarray(jbase.tree_normal_like(key_n, like)["x"])
    eps_v = (np.asarray(jbase.tree_normal_like(key_r, like)["x"])
             if resample else None)
    return eps, eps_v


def _torch_noise(noise):
    if isinstance(noise, tuple):
        return tuple(None if n is None else _t(n) for n in noise)
    return _t(noise)


def _to_torch(jst):
    """The port's state from a JAX ``SGMCMCState``."""
    def tree(d):
        return {k: _t(v) for k, v in d.items()}

    return SGMCMCState(q=tree(jst.q), t=int(jst.t), v=tree(jst.v),
                       alpha=tree(jst.alpha), rms=tree(jst.rms))


def _close(got, want, tol):
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()  # NaN == NaN would pass allclose
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _close_state(tst, jst, tol):
    assert tst.t == int(jst.t)
    for field in ("q", "v", "alpha", "rms"):
        _close(getattr(tst, field), getattr(jst, field), tol)


def _close_info(tinfo, jinfo, tol):
    for field in ("q", "mean_k", "alpha"):
        _close(getattr(tinfo, field), getattr(jinfo, field), tol)


def _random_state(name, jsampler, seed, scale=STD):
    """A JAX state away from the initial one: positions, momenta,
    thermostats and accumulators drawn from numpy."""
    rs = np.random.RandomState(seed)
    q = {"x": jnp.asarray(rs.randn(C, D) * scale)}
    jst = jsampler.init(q, key=jax.random.PRNGKey(seed))
    fields = {}
    if _momentum(name):
        fields["v"] = {"x": jnp.asarray(0.1 * rs.randn(C, D))}
    if name == "SGNHT":
        a = jst.alpha["x"]
        fields["alpha"] = {"x": jnp.asarray(
            np.asarray(a) + 0.02 * rs.randn(*a.shape))}
    if name == "PSGLD":
        fields["rms"] = {"x": jnp.asarray(rs.uniform(0.5, 4.0, (C, D)))}
    return jst._replace(**fields)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", SAMPLERS, ids=SAMPLER_IDS)
def test_init_matches_jax(name, kw):
    js, ts = _pair(name, kw)
    q0 = np.random.RandomState(1).randn(C, D)
    key = jax.random.PRNGKey(3)
    jst = js.init({"x": jnp.asarray(q0)}, key=key)
    noise = np.asarray(jbase.tree_normal_like(key, {"x": jnp.asarray(q0)})[
        "x"])
    tst = ts.init({"x": _t(q0)}, key=(1, 2), noise=_t(noise))
    _close_state(tst, jst, TOL_ONE)
    assert tst.t == 0
    if name == "SGNHT" and not kw["use_vector_alpha"]:
        assert tst.alpha["x"].shape == ()
    # Without injected normals the port draws its own, reproducibly.
    if _momentum(name):
        a = ts.init({"x": _t(q0)}, key=(1, 2))
        b = ts.init({"x": _t(q0)}, key=(1, 2))
        assert torch.equal(a.v["x"], b.v["x"])
        assert not torch.equal(a.v["x"], tst.v["x"])


# --------------------------------------------------------------------- #
# one sample, at a resample iteration (t = 0) and a plain one
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [0, 3])
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name,kw", SAMPLERS, ids=SAMPLER_IDS)
def test_one_sample_matches_jax(name, kw, target, t):
    js, ts = _pair(name, kw)
    jlj, tlj = _target(target)
    jst = _random_state(name, js, 5 + t,
                        0.5 if target == "double_well" else STD)
    jst = jst._replace(t=jnp.asarray(t, jnp.int32))
    key = jax.random.PRNGKey(11 + t)
    jnew, jinfo = js.sample(jlj, {}, jst, key)
    resample = _momentum(name) and kw.get("n_iter_resample_v") and t == 0
    noise = _jax_noise(name, key, jst.q["x"], resample)
    tnew, tinfo = ts.sample(tlj, {}, _to_torch(jst),
                            noise=_torch_noise(noise))
    _close_state(tnew, jnew, TOL_ONE)
    _close_info(tinfo, jinfo, TOL_ONE)
    assert tnew.q["x"].dtype == torch.float64


# --------------------------------------------------------------------- #
# 30 chained samples from init, resampling inside the window
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("name,kw", SAMPLERS, ids=SAMPLER_IDS)
def test_chained_samples_match_jax(name, kw, target):
    js, ts = _pair(name, kw)
    jlj, tlj = _target(target)
    # The double well's gradient -4x^3 throws chains far out of [-2, 2].
    scale = 0.5 if target == "double_well" else STD
    q0 = np.random.RandomState(2).randn(C, D) * scale
    key0 = jax.random.PRNGKey(21)
    jst = js.init({"x": jnp.asarray(q0)}, key=key0)
    tst = ts.init({"x": _t(q0)}, noise=_t(np.asarray(
        jbase.tree_normal_like(key0, {"x": jnp.asarray(q0)})["x"])))
    step = jax.jit(lambda s, k: js.sample(jlj, {}, s, k))
    for i in range(30):
        key = jax.random.PRNGKey(300 + i)
        resample = _momentum(name) and bool(
            ts.n_iter_resample_v and i % ts.n_iter_resample_v == 0)
        noise = _jax_noise(name, key, jst.q["x"], resample)
        jst, jinfo = step(jst, key)
        tst, tinfo = ts.sample(tlj, {}, tst, noise=_torch_noise(noise))
    _close_state(tst, jst, TOL_CHAIN)
    _close_info(tinfo, jinfo, TOL_CHAIN)
    assert tst.t == 30
    assert torch.isfinite(tst.q["x"]).all()


# --------------------------------------------------------------------- #
# run: JAX's key thread, thinning, collect_info
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [SAMPLERS[0], SAMPLERS[3], SAMPLERS[5]],
                         ids=[SAMPLER_IDS[0], SAMPLER_IDS[3],
                              SAMPLER_IDS[5]])
def test_run_rows_match_jax_thinned_run(name, kw):
    """JAX's thinned ``run`` with ``collect_info`` against the port's
    samples on the same key thread (``k, sub = split(k)``): the rows are
    iterations thinning-1, 2 thinning-1, ... and the final state is the
    whole run's."""
    js, ts = _pair(name, kw)
    jlj, tlj = _target("diagonal")
    q0 = np.random.RandomState(4).randn(C, D) * STD
    key0 = jax.random.PRNGKey(8)
    jst = js.init({"x": jnp.asarray(q0)}, key=key0)
    tst = ts.init({"x": _t(q0)}, noise=_t(np.asarray(
        jbase.tree_normal_like(key0, {"x": jnp.asarray(q0)})["x"])))
    n_iters, thinning = 11, 3
    jfinal, jqs, jinfos = js.run(jlj, {}, jst, jax.random.PRNGKey(9),
                                 n_iters, thinning=thinning,
                                 collect_info=True)
    k = jax.random.PRNGKey(9)
    rows, infos = [], []
    for i in range(n_iters):
        k, sub = jax.random.split(k)
        resample = _momentum(name) and i % ts.n_iter_resample_v == 0
        noise = _jax_noise(name, sub, np.asarray(
            tst.q["x"]), resample)
        tst, tinfo = ts.sample(tlj, {}, tst, noise=_torch_noise(noise))
        if (i + 1) % thinning == 0:
            rows.append(tinfo.q["x"])
            infos.append(tinfo)
    assert jqs["x"].shape == (n_iters // thinning, C, D)
    _close(torch.stack(rows), jqs["x"], TOL_CHAIN)
    if name != "SGLD":
        _close(torch.stack([i.mean_k["x"] for i in infos]),
               jinfos.mean_k["x"], TOL_CHAIN)
    else:
        assert jinfos.mean_k is None
    _close_state(tst, jfinal, TOL_CHAIN)


@pytest.mark.parametrize("name,kw", SAMPLERS, ids=SAMPLER_IDS)
def test_thinned_run_ends_where_the_unthinned_run_ends(name, kw):
    ts = getattr(tsg, name)(**kw)
    _, tlj = _target("double_well")
    st = ts.init({"x": torch.zeros(16, 3, dtype=torch.float64)}, key=(1, 2))
    full, qs = ts.run(tlj, {}, st, (5, 6), 23)
    thin, tqs, infos = ts.run(tlj, {}, st, (5, 6), 23, thinning=4,
                              collect_info=True)
    _close_state(thin, _numpy_state(full), 0.0)
    assert qs["x"].shape == (23, 16, 3)
    assert torch.equal(tqs["x"], qs["x"][3::4][:5])
    assert infos.q["x"] is tqs["x"]
    if _momentum(name):
        assert infos.mean_k["x"].shape[0] == 5
    else:
        assert infos.mean_k is None and infos.alpha is None
    if name == "SGNHT":
        want = (5, 16, 3) if kw["use_vector_alpha"] else (5,)
        assert infos.alpha["x"].shape == want
    # collect=False: no draws, the same end; with collect_info the infos
    # of every iteration.
    none_state, none = ts.run(tlj, {}, st, (5, 6), 23, collect=False)
    assert none is None
    _close_state(none_state, _numpy_state(full), 0.0)
    _, none, every = ts.run(tlj, {}, st, (5, 6), 23, collect=False,
                            thinning=4, collect_info=True)
    assert none is None and every.q["x"].shape == (23, 16, 3)
    assert torch.equal(every.q["x"], qs["x"])


def _numpy_state(st):
    return SGMCMCState(
        q={k: v.numpy() for k, v in st.q.items()}, t=st.t,
        v={k: v.numpy() for k, v in st.v.items()},
        alpha={k: v.numpy() for k, v in st.alpha.items()},
        rms={k: v.numpy() for k, v in st.rms.items()})


# --------------------------------------------------------------------- #
# a callable learning rate
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", [SAMPLERS[0], SAMPLERS[3], SAMPLERS[5]],
                         ids=[SAMPLER_IDS[0], SAMPLER_IDS[3],
                              SAMPLER_IDS[5]])
def test_callable_learning_rate_matches_jax(name, kw):
    kw = dict(kw, learning_rate=lambda t: 0.01 / (1.0 + t) ** 0.55)
    js, ts = _pair(name, kw)
    jlj, tlj = _target("equicorrelated")
    q0 = np.random.RandomState(6).randn(C, D)
    key0 = jax.random.PRNGKey(12)
    jst = js.init({"x": jnp.asarray(q0)}, key=key0)
    tst = ts.init({"x": _t(q0)}, noise=_t(np.asarray(
        jbase.tree_normal_like(key0, {"x": jnp.asarray(q0)})["x"])))
    step = jax.jit(lambda s, k: js.sample(jlj, {}, s, k))
    for i in range(9):
        key = jax.random.PRNGKey(40 + i)
        resample = _momentum(name) and i % ts.n_iter_resample_v == 0
        noise = _jax_noise(name, key, jst.q["x"], resample)
        jst, jinfo = step(jst, key)
        tst, tinfo = ts.sample(tlj, {}, tst, noise=_torch_noise(noise))
    _close_state(tst, jst, TOL_CHAIN)
    _close_info(tinfo, jinfo, TOL_CHAIN)


def test_learning_rate_tensor_schedule_runs():
    """A schedule may return a tensor (on the state's device or the
    host); the state stays in its dtype."""
    _, tlj = _target("diagonal")
    for make in (lambda t: torch.tensor(0.01 / (1.0 + t)),
                 lambda t: torch.tensor(0.01, dtype=torch.float64)):
        ts = tsg.SGHMC(learning_rate=make, n_iter_resample_v=3)
        st = ts.init({"x": torch.zeros(8, D)}, key=(1, 2))
        st, qs = ts.run(tlj, {}, st, (3, 4), 10)
        assert qs["x"].dtype == torch.float32
        assert st.v["x"].dtype == torch.float32
        assert torch.isfinite(qs["x"]).all()


# --------------------------------------------------------------------- #
# constructor and init errors
# --------------------------------------------------------------------- #
def test_constructor_and_init_errors():
    with pytest.raises(ValueError, match="must be < friction"):
        tsg.SGHMC(learning_rate=0.01, friction=0.1, variance_estimate=0.1)
    with pytest.raises(ValueError, match="must be < friction"):
        tsg.SGHMC(learning_rate=0.01, friction=0.1, variance_estimate=0.2)
    for cls in (tsg.SGLD, tsg.PSGLD, tsg.SGHMC, tsg.SGNHT):
        with pytest.raises(ValueError, match="experimental_fused_step"):
            cls(learning_rate=0.01, experimental_fused_step="sometimes")
    q = {"x": torch.zeros(4, 3)}
    for cls in (tsg.SGHMC, tsg.SGNHT):
        with pytest.raises(ValueError, match="requires a key"):
            cls(learning_rate=0.01).init(q)
    # SGLD and PSGLD need none.
    assert tsg.SGLD(0.01).init(q).v == {}
    assert torch.equal(tsg.PSGLD(0.01).init(q).rms["x"], torch.zeros(4, 3))
    ts = tsg.SGLD(0.01)
    with pytest.raises(ValueError, match="thinning"):
        ts.run(lambda o: -(o["x"] ** 2).sum(-1), {}, ts.init(q), (1, 2), 3,
               thinning=0)
    # The resample normals must come with a resampling iteration's noise.
    tsh = tsg.SGHMC(0.01, n_iter_resample_v=2)
    st = tsh.init(q, key=(1, 2))
    with pytest.raises(ValueError, match="resample"):
        tsh.sample(lambda o: -(o["x"] ** 2).sum(-1), {}, st,
                   noise=(torch.zeros(4, 3), None))
    with pytest.raises(ValueError, match="learning rate"):
        tsg.SGLD(torch.ones(2)).sample(lambda o: -(o["x"] ** 2).sum(-1), {},
                                       ts.init(q), (1, 2))


def test_plain_path_noise_scales_stay_in_the_state_dtype():
    """A float64 density over a float32 state keeps the float32 state
    (ROADMAP "Dtype pinning")."""
    def lj(obs):
        return -0.5 * (obs["x"].double() ** 2).sum(-1)

    for ts in (tsg.SGLD(0.01), tsg.PSGLD(0.01), tsg.SGHMC(0.01),
               tsg.SGNHT(0.01, variance_extra=0.1),
               tsg.SGNHT(0.01, variance_extra=0.1, use_vector_alpha=False)):
        st = ts.init({"x": torch.zeros(8, 3)}, key=(1, 2))
        st, info = ts.sample(lj, {}, st, (3, 4))
        for field in ("q", "v", "alpha", "rms"):
            for v in getattr(st, field).values():
                assert v.dtype == torch.float32, (type(ts).__name__, field)
