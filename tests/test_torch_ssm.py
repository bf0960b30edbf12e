"""Parity of the port's state-space module (``zhusuan_tpu_torch/ssm.py``)
with ``zhusuan_tpu/ssm.py`` in float64 on the CPU, on the JAX draws.

The tests rebuild JAX's draws from its key splits and feed them through the
port's ``noise=`` hooks:

- ``ParticleFilter.run(key)`` splits ``k_init, k_scan``; ``init_fn`` draws
  from ``k_init``; step ``t`` takes ``split(k_scan, T)[t]`` and splits it
  ``k_res, k_prop``: the resampling uniform ``uniform(k_res, (), f64)``
  (the port's ``noise``) and the proposal's normals from ``k_prop``, which
  the test's callables read by ``t``;
- ``smooth(key)`` splits ``key`` over the paths, each ``k_last, k_back``,
  ``k_back`` over the T-1 backward steps; categorical draws are Gumbel-max,
  ``gumbel(k, (n,))``;
- ``conditional_run(key)`` splits ``k_init, k_scan, k_pick``; a step
  ``k_anc, k_res, k_prop``; the multinomial ancestors take ``gumbel(k_res,
  (n, n))``;
- ``ParticleGibbs.run`` splits ``key`` over the sweeps, each ``k_traj,
  k_par``;
- ``PseudoMarginalMH.run`` splits ``key`` over the iterations; ``sample``
  splits ``k_fill, k_prop, k_z, k_mh``, the estimates taking
  ``split(k_fill / k_z, n_chains)``.

Everything is held at 1e-10; the HMM and Kalman functions sequential and
``parallel=True`` at T in {1, 2, 7, 50}, with impossible HMM states; the
parallel Kalman gradient; the validation errors against JAX's messages;
and the host reads of a filter step (none).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu_torch import ssm as tssm

TOL = 1e-10

A = np.array([[0.9, 0.1], [0.0, 0.8]])
Q_SCALE = 0.1
Q = Q_SCALE * np.eye(2)
H = np.array([[1.0, 0.5]])
R_SCALE = 0.5
R = np.array([[R_SCALE]])
M0 = np.zeros(2)
P0 = np.eye(2)
D = 2
T_LEN = 30
N = 16
CHOL_Q = np.linalg.cholesky(Q)


def _simulate(T, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.multivariate_normal(M0, P0)
    ys = np.empty((T, 1))
    for t in range(T):
        if t > 0:
            x = A @ x + rng.multivariate_normal(np.zeros(D), Q)
        ys[t] = H @ x + rng.multivariate_normal(np.zeros(1), R)
    return ys


YS = _simulate(50)


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


# -- the linear-Gaussian model in both packages ----------------------------

def j_emission(x, y, t):
    mu = x @ jnp.asarray(H).T
    return jnp.sum(-0.5 * (y - mu) ** 2 / R_SCALE
                   - 0.5 * jnp.log(2.0 * jnp.pi * R_SCALE), axis=-1)


def t_emission(x, y, t):
    mu = x @ _t(H).T
    return torch.sum(-0.5 * (y - mu) ** 2 / R_SCALE
                     - 0.5 * np.log(2.0 * np.pi * R_SCALE), dim=-1)


def j_tlp(x_new, x_old, t):
    diff = x_new - x_old @ jnp.asarray(A).T
    return (-0.5 * jnp.sum(diff ** 2, -1) / Q_SCALE
            - 0.5 * D * jnp.log(2.0 * jnp.pi * Q_SCALE))


def t_tlp(x_new, x_old, t):
    diff = x_new - x_old @ _t(A).T
    return (-0.5 * torch.sum(diff ** 2, -1) / Q_SCALE
            - 0.5 * D * np.log(2.0 * np.pi * Q_SCALE))


PROP_SCALE = 0.4


def j_plp(x_new, x_old, y, t):
    diff = x_new - (x_old @ jnp.asarray(A).T + 0.2 * y)
    return (-0.5 * jnp.sum(diff ** 2, -1) / PROP_SCALE ** 2
            - D * jnp.log(PROP_SCALE) - 0.5 * D * jnp.log(2.0 * jnp.pi))


def t_plp(x_new, x_old, y, t):
    diff = x_new - (x_old @ _t(A).T + 0.2 * y)
    return (-0.5 * torch.sum(diff ** 2, -1) / PROP_SCALE ** 2
            - D * np.log(PROP_SCALE) - 0.5 * D * np.log(2.0 * np.pi))


def j_filter(n=N, guided=False, **kw):
    def init_fn(key, n):
        return jax.random.normal(key, (n, D), jnp.float64)

    def transition_fn(key, x, t):
        eps = jax.random.normal(key, x.shape, x.dtype)
        return x @ jnp.asarray(A).T + eps @ jnp.asarray(CHOL_Q).T

    extra = {}
    if guided:
        extra = dict(
            proposal_fn=lambda key, x, y, t: (
                x @ jnp.asarray(A).T + 0.2 * y
                + PROP_SCALE * jax.random.normal(key, x.shape, x.dtype)),
            proposal_log_prob=j_plp, transition_log_prob=j_tlp)
    kw.setdefault("transition_log_prob", j_tlp)
    return zs.ParticleFilter(init_fn, transition_fn, j_emission,
                             n_particles=n, **{**kw, **extra})


def t_filter(init, eps, n=N, guided=False, **kw):
    """The port's filter whose callables read JAX's normals: ``init``
    ``[n, D]``, ``eps[t]`` the step's ``[n, D]`` proposal normals."""
    extra = {}
    if guided:
        extra = dict(
            proposal_fn=lambda gen, x, y, t: (
                x @ _t(A).T + 0.2 * y + PROP_SCALE * _t(eps[t])),
            proposal_log_prob=t_plp, transition_log_prob=t_tlp)
    kw.setdefault("transition_log_prob", t_tlp)
    return tssm.ParticleFilter(
        lambda gen, n: _t(init),
        lambda gen, x, t: x @ _t(A).T + _t(eps[t]) @ _t(CHOL_Q).T,
        t_emission, n_particles=n, **{**kw, **extra})


def _jit(fn, **kw):
    """``fn`` jitted: one XLA program per shape in place of eager JAX's
    program per primitive (3-10x faster here)."""
    return jax.jit(fn, **kw)


def _run_draws(key, T, n=N, d=D):
    """JAX ``ParticleFilter.run``'s draws: init normals, the [T] resampling
    uniforms and the [T, n, d] proposal normals."""
    return _run_draws_jit(key, T, n, d)


def _run_draws_jax(key, T, n, d):
    k_init, k_scan = jax.random.split(key)

    def step(kk):
        k_res, k_prop = jax.random.split(kk)
        return (jax.random.uniform(k_res, (), jnp.float64),
                jax.random.normal(k_prop, (n, d), jnp.float64))

    us, eps = jax.vmap(step)(jax.random.split(k_scan, T))
    return jax.random.normal(k_init, (n, d), jnp.float64), us, eps


_run_draws_jit = jax.jit(_run_draws_jax, static_argnums=(1, 2, 3))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _gumbel_paths_jax(key, n_paths, T, n):
    def one(k):
        k_last, k_back = jax.random.split(k)
        back = jax.vmap(lambda kk: jax.random.gumbel(kk, (n,), jnp.float64))(
            jax.random.split(k_back, T - 1))
        return jax.random.gumbel(k_last, (n,), jnp.float64), back

    return jax.vmap(one)(jax.random.split(key, n_paths))


def _gumbel_paths(key, n_paths, T, n):
    """FFBS's Gumbels: ``split(key, n_paths)``, each ``k_last, k_back``,
    ``k_back`` split over the T-1 backward steps."""
    last, back = _gumbel_paths_jax(key, n_paths, T, n)
    return {"last": _t(last), "back": _t(back)}


@pytest.mark.parametrize("guided", [False, True])
def test_filter_run_and_smooth(guided):
    ys = YS[:T_LEN]
    key = jax.random.PRNGKey(3)
    jpf = j_filter(guided=guided)
    jres = _jit(lambda k: jpf.run(k, jnp.asarray(ys),
                                  store_history=True))(key)
    init, us, eps = map(np.asarray, _run_draws(key, T_LEN))
    tpf = t_filter(init, eps, guided=guided)
    tres = tpf.run(None, _t(ys), store_history=True, noise=_t(us))
    for f in ("particles", "log_w", "log_z", "filter_means", "ess",
              "history", "log_w_history"):
        _close(getattr(tres, f), getattr(jres, f))
    assert int(tres.n_resamples) == int(jres.n_resamples)
    assert 0 < int(tres.n_resamples) < T_LEN
    plain = tpf.run(None, _t(ys), noise=_t(us))
    assert plain.history is None and plain.log_w_history is None
    _close(plain.log_z, jres.log_z)

    # FFBS over 5 paths on JAX's Gumbels.
    k_s = jax.random.PRNGKey(8)
    n_paths = 5
    want = _jit(lambda k: jpf.smooth(k, jres, n_paths))(k_s)
    got = tpf.smooth(None, tres, n_paths,
                     noise=_gumbel_paths(k_s, n_paths, T_LEN, N))
    _close(got, want)


@pytest.mark.parametrize("ancestor_sampling", [True, False])
@pytest.mark.parametrize("guided", [False, True])
def test_conditional_run(ancestor_sampling, guided):
    T = 12
    ys = YS[:T]
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((T, D))
    key = jax.random.PRNGKey(21)
    jres = _jit(lambda k: j_filter(guided=guided).conditional_run(
        k, jnp.asarray(ys), jnp.asarray(ref),
        ancestor_sampling=ancestor_sampling))(key)
    init, eps, noise = _csmc_draws(key, T, N, D)
    tres = t_filter(init, eps, guided=guided).conditional_run(
        None, _t(ys), _t(ref), ancestor_sampling=ancestor_sampling,
        noise=noise)
    _close(tres.trajectory, jres.trajectory)
    _close(tres.log_z, jres.log_z)
    assert int(tres.ancestor_moves) == int(jres.ancestor_moves)
    if ancestor_sampling:
        assert int(tres.ancestor_moves) > 0


# -- particle Gibbs and PMMH on a scalar LGSSM -----------------------------

Q1, R1 = 0.09, 0.16
T1, N1 = 10, 8


def _scalar_data():
    rng = np.random.default_rng(11)
    x, ys = rng.standard_normal(), []
    for t in range(T1):
        if t > 0:
            x = 0.8 * x + np.sqrt(Q1) * rng.standard_normal()
        ys.append(x + np.sqrt(R1) * rng.standard_normal())
    return np.array(ys)[:, None]


def j_scalar_filter(a, n=N1):
    return zs.ParticleFilter(
        init_fn=lambda k, n: jax.random.normal(k, (n, 1), jnp.float64),
        transition_fn=lambda k, x, t: a * x + jnp.sqrt(Q1)
        * jax.random.normal(k, x.shape, x.dtype),
        emission_log_prob=lambda x, y, t: jnp.sum(
            -0.5 * (y - x) ** 2 / R1 - 0.5 * jnp.log(2 * jnp.pi * R1), -1),
        transition_log_prob=lambda xn, xo, t: jnp.sum(
            -0.5 * (xn - a * xo) ** 2 / Q1
            - 0.5 * jnp.log(2 * jnp.pi * Q1), -1),
        n_particles=n)


def t_scalar_filter(a, init, eps, n=N1):
    return tssm.ParticleFilter(
        init_fn=lambda g, n: init,
        transition_fn=lambda g, x, t: a * x + np.sqrt(Q1) * eps[t],
        emission_log_prob=lambda x, y, t: torch.sum(
            -0.5 * (y - x) ** 2 / R1 - 0.5 * np.log(2 * np.pi * R1), -1),
        transition_log_prob=lambda xn, xo, t: torch.sum(
            -0.5 * (xn - a * xo) ** 2 / Q1
            - 0.5 * np.log(2 * np.pi * Q1), -1),
        n_particles=n)


def _csmc_draws(key, T, n, d=1):
    """``conditional_run``'s draws: init normals, the [T, n, d] proposal
    normals and the Gumbels of the ancestors and the final pick."""
    init, eps, res, anc, pick = _csmc_draws_jit(key, T, n, d)
    return (np.asarray(init), np.asarray(eps),
            {"res": _t(res), "anc": _t(anc), "pick": _t(pick)})


def _csmc_draws_jax(key, T, n, d):
    k_init, k_scan, k_pick = jax.random.split(key, 3)

    def step(kk):
        k_anc, k_res, k_prop = jax.random.split(kk, 3)
        return (jax.random.normal(k_prop, (n, d), jnp.float64),
                jax.random.gumbel(k_res, (n, n), jnp.float64),
                jax.random.gumbel(k_anc, (n,), jnp.float64))

    eps, res, anc = jax.vmap(step)(jax.random.split(k_scan, T))
    return (jax.random.normal(k_init, (n, d), jnp.float64), eps, res, anc,
            jax.random.gumbel(k_pick, (n,), jnp.float64))


_csmc_draws_jit = jax.jit(_csmc_draws_jax, static_argnums=(1, 2, 3))


def test_particle_gibbs_two_sweeps():
    ys = _scalar_data()

    def j_update(k, theta, traj):
        # Conjugate a | x ~ N(m, s^2) under an N(0.5, 0.5^2) prior.
        x = traj[:, 0]
        prec = 4.0 + jnp.sum(x[:-1] ** 2) / Q1
        m = (2.0 + jnp.sum(x[1:] * x[:-1]) / Q1) / prec
        return {"a": m + jax.random.normal(k, (), jnp.float64)
                / jnp.sqrt(prec)}

    def t_update(z, theta, traj):
        x = traj[:, 0]
        prec = 4.0 + torch.sum(x[:-1] ** 2) / Q1
        m = (2.0 + torch.sum(x[1:] * x[:-1]) / Q1) / prec
        return {"a": m + z / torch.sqrt(prec)}

    key = jax.random.PRNGKey(4)
    n_sweeps = 2
    ref0 = np.zeros((T1, 1))
    jpg = zs.ParticleGibbs(lambda th: j_scalar_filter(th["a"]), j_update)
    jtheta, jtraj, jout = _jit(lambda k: jpg.run(
        k, jnp.asarray(ys), {"a": jnp.float64(0.3)}, jnp.asarray(ref0),
        n_sweeps, collect_fields=("params", "trajectory", "log_z",
                                  "ancestor_moves")))(key)
    sweeps, noise = [], []
    for kk in jax.random.split(key, n_sweeps):
        k_traj, k_par = jax.random.split(kk)
        init, eps, nz = _csmc_draws(k_traj, T1, N1, 1)
        sweeps.append((init, eps))
        noise.append((nz, _t(jax.random.normal(k_par, (), jnp.float64))))
    made = iter(sweeps)

    def make_filter(theta):
        init, eps = next(made)
        return t_scalar_filter(theta["a"], _t(init), _t(eps))

    tpg = tssm.ParticleGibbs(make_filter, t_update)
    ttheta, ttraj, tout = tpg.run(
        None, _t(ys), {"a": _t(0.3)}, _t(ref0), n_sweeps,
        collect_fields=("params", "trajectory", "log_z", "ancestor_moves"),
        noise=noise)
    _close(ttheta["a"], jtheta["a"])
    _close(ttraj, jtraj)
    _close(tout["params"]["a"], jout["params"]["a"])
    _close(tout["trajectory"], jout["trajectory"])
    _close(tout["log_z"], jout["log_z"])
    np.testing.assert_array_equal(_np(tout["ancestor_moves"]),
                                  np.asarray(jout["ancestor_moves"]))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _chain_draws(key, n_chains, T, n):
    return jax.vmap(lambda kc: _run_draws_jax(kc, T, n, 1))(
        jax.random.split(key, n_chains))


def _chain_keys(key, n_chains, T, n):
    """The per-chain filter draws of ``split(key, n_chains)``, stacked on a
    leading chain axis (the port's per-chain ``log_z_fn`` keys)."""
    init, us, eps = _chain_draws(key, n_chains, T, n)
    return {"init": _t(init), "u": _t(us), "eps": _t(eps)}


@functools.partial(jax.jit, static_argnums=(1,))
def _pmmh_split(key, n_chains):
    k_fill, k_prop, k_z, k_mh = jax.random.split(key, 4)
    # tree_normal_like of a one-latent dict: split(k_prop, 1)[0].
    (k_a,) = jax.random.split(k_prop, 1)
    return (k_fill, jax.random.normal(k_a, (n_chains,), jnp.float64), k_z,
            jax.random.uniform(k_mh, (n_chains,)))


def _pmmh_noise(key, n_chains):
    """``sample(key)``'s draws for the one-latent ``{"a": [C]}`` theta."""
    k_fill, eps, k_z, u = _pmmh_split(key, n_chains)
    return (_chain_keys(k_fill, n_chains, T1, N1), {"a": _t(eps)},
            _chain_keys(k_z, n_chains, T1, N1), _t(u))


def _pmmh_pair(ys, **kw):
    def j_log_z(theta, key):
        return j_scalar_filter(theta["a"]).run(key, ys).log_z

    def t_log_z(theta, key):
        pf = t_scalar_filter(theta["a"], key["init"], key["eps"])
        return pf.run(None, _t(ys), noise=key["u"]).log_z

    def j_prior(theta):
        return -0.5 * ((theta["a"] - 0.5) / 0.5) ** 2

    def t_prior(theta):
        return -0.5 * ((theta["a"] - 0.5) / 0.5) ** 2

    return (zs.PseudoMarginalMH(j_log_z, j_prior, **kw),
            tssm.PseudoMarginalMH(t_log_z, t_prior, **kw))


def test_pmmh_30_iterations_and_refill():
    ys = _scalar_data()
    C, n_iters = 4, 30
    jk, tk = _pmmh_pair(jnp.asarray(ys), step_size=0.3,
                        proposal_scales={"a": 0.5}, adapt_step_size=True,
                        target_acceptance_rate=0.3)
    theta0 = np.linspace(0.4, 1.0, C)
    js = jk.init({"a": jnp.asarray(theta0)})
    ts = tk.init({"a": _t(theta0)})
    key = jax.random.PRNGKey(9)
    jfinal, jout = jax.jit(lambda s, k: jk.run(s, k, n_iters, n_adapt=15))(
        js, key)
    noise = [_pmmh_noise(kk, C) for kk in jax.random.split(key, n_iters)]
    tfinal, tout = tk.run(ts, None, n_iters, n_adapt=15, noise=noise)
    for f in ("acceptance_rate", "step_size", "log_post"):
        _close(tout[f], jout[f])
    _close(tout["samples"]["a"], jout["samples"]["a"])
    for f in ("log_post", "step_size", "da_step", "h_bar", "log_epsilon_bar"):
        _close(getattr(tfinal, f), getattr(jfinal, f))
    assert tfinal.t == n_iters == int(jfinal.t)
    acc = _np(tout["acceptance_rate"])
    assert 0.0 < acc.mean() < 1.0

    # The refill after invalidate_cache.
    key2 = jax.random.PRNGKey(10)
    jst = jfinal.invalidate_cache()
    tst = tfinal.invalidate_cache()
    assert torch.isnan(tst.log_post).all()
    j2, _ = _jit(jk.sample)(jst, key2)
    t2, _ = tk.sample(tst, noise=_pmmh_noise(key2, C))
    _close(t2.log_post, j2.log_post)
    _close(t2.theta["a"], j2.theta["a"])
    assert torch.isfinite(t2.log_post).all()


def test_pmmh_own_draws_batch_and_host_reads():
    """The chains run as one vmapped batch on the port's own draws: two
    runs on one key agree, the refill fills, and a filter step reads
    nothing back (no ``aten::_local_scalar_dense`` inside the loop over T;
    PMMH's sentinel test is one read an iteration)."""
    ys = _t(_scalar_data())

    def make(a):
        return tssm.ParticleFilter(
            init_fn=lambda g, n: torch.randn(n, 1, generator=g,
                                             dtype=torch.float64),
            transition_fn=lambda g, x, t: a * x + np.sqrt(Q1) * torch.randn(
                x.shape, generator=g, dtype=x.dtype),
            emission_log_prob=lambda x, y, t: torch.sum(
                -0.5 * (y - x) ** 2 / R1 - 0.5 * np.log(2 * np.pi * R1), -1),
            n_particles=32)

    calls = []

    def log_z_fn(th, k):
        calls.append(th["a"].shape)
        return make(th["a"]).run(k, ys).log_z

    kern = tssm.PseudoMarginalMH(
        log_z_fn, lambda th: -0.5 * ((th["a"] - 0.5) / 0.5) ** 2,
        step_size=0.2)
    st = kern.init({"a": torch.full((3,), 0.7, dtype=torch.float64)})
    s1, o1 = kern.run(st, (1, 2), 8)
    # One vmapped call an estimate (the refill's, then one an iteration),
    # each seeing one chain's theta: the chains run as one batch.
    assert calls == [torch.Size([])] * 9
    s2, o2 = kern.run(st, (1, 2), 8)
    assert torch.equal(o1["samples"]["a"], o2["samples"]["a"])
    # The chains draw different numbers under vmap.
    assert len(set(_np(o1["log_post"][0]).round(8))) == 3
    st3, _ = kern.sample(s1.invalidate_cache(), (3, 4))
    assert torch.isfinite(st3.log_post).all()

    pf = make(torch.tensor(0.8, dtype=torch.float64))
    pf.run((5, 6), ys)  # warm up
    with torch.profiler.profile() as prof:
        pf.run((5, 6), ys)
    reads = [e for e in prof.events() if e.name == "aten::_local_scalar_dense"]
    assert reads == []
    with torch.profiler.profile() as prof:
        kern.sample(s1, (7, 8))
    reads = [e for e in prof.events() if e.name == "aten::_local_scalar_dense"]
    assert len(reads) == 1


# -- exact HMMs --------------------------------------------------------------

K_HMM = 4


def _hmm(T, seed=0, impossible=True):
    rng = np.random.default_rng(seed)
    log_pi0 = np.log(rng.dirichlet(np.ones(K_HMM)))
    log_trans = np.log(rng.dirichlet(np.ones(K_HMM), size=K_HMM))
    if impossible:
        # State 3 can never be entered and never starts: -inf columns.
        log_pi0[3] = -np.inf
        log_trans[:, 3] = -np.inf
        log_trans[:3] -= np.log(np.exp(log_trans[:3]).sum(1, keepdims=True))
    log_obs = rng.normal(size=(T, K_HMM))
    return log_pi0, log_trans, log_obs


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_hmm_all(log_pi0, log_trans, log_obs, key, n_paths):
    """Every JAX HMM function on one model, as one XLA program."""
    T = log_obs.shape[0]
    out = {}
    for parallel in (False, True):
        out["filter", parallel] = zs.hmm_filter(log_pi0, log_trans, log_obs,
                                                parallel=parallel)
        out["smoother", parallel] = zs.hmm_smoother(
            log_pi0, log_trans, log_obs, parallel=parallel)
        out["backward", parallel] = zs.ssm._hmm_backward(
            log_trans, log_obs, parallel)
        if T >= 2:
            stats = zs.hmm_expected_stats(log_pi0, log_trans, log_obs,
                                          parallel=parallel)
            out["stats", parallel] = tuple(stats)
            out["mstep", parallel] = zs.hmm_mstep(stats)
    out["viterbi", False] = zs.hmm_viterbi(log_pi0, log_trans, log_obs)
    out["sample", False] = zs.hmm_posterior_sample(key, log_pi0, log_trans,
                                                   log_obs, n_paths)
    return out


@pytest.mark.parametrize("T", [1, 2, 7, 50])
@pytest.mark.parametrize("impossible", [False, True])
def test_hmm_functions(T, impossible):
    args = _hmm(T, seed=T, impossible=impossible)
    targs = tuple(_t(a) for a in args)
    key = jax.random.PRNGKey(T)
    n_paths = 6
    want = _jax_hmm_all(*args, key, n_paths)
    for parallel in (False, True):
        got = {"filter": tssm.hmm_filter(*targs, parallel=parallel),
               "smoother": tssm.hmm_smoother(*targs, parallel=parallel),
               "backward": (tssm._hmm_backward(targs[1], targs[2],
                                               parallel),)}
        if T >= 2:
            stats = tssm.hmm_expected_stats(*targs, parallel=parallel)
            got["stats"] = tuple(stats)
            got["mstep"] = tssm.hmm_mstep(stats)
        for name, values in got.items():
            w = want[name, parallel]
            w = (w,) if name == "backward" else w
            for g, v in zip(values, w):
                _close(g, v)
                if name in ("filter", "smoother"):
                    assert not np.isnan(_np(g)).any()
    # Both paths agree in the port.
    for fn in ("hmm_filter", "hmm_smoother"):
        for s, p in zip(getattr(tssm, fn)(*targs),
                        getattr(tssm, fn)(*targs, parallel=True)):
            _close(s, p)
    path, score = tssm.hmm_viterbi(*targs)
    jpath, jscore = want["viterbi", False]
    np.testing.assert_array_equal(_np(path), np.asarray(jpath))
    _close(score, jscore)
    got = tssm.hmm_posterior_sample(
        None, *targs, n_paths, noise=_gumbel_paths(key, n_paths, T, K_HMM))
    np.testing.assert_array_equal(_np(got), np.asarray(want["sample",
                                                            False]))
    if impossible:
        assert not (_np(got) == 3).any() and not (_np(path) == 3).any()


# -- exact Kalman ------------------------------------------------------------


@jax.jit
def _jax_kalman_all(ys):
    """Both JAX Kalman functions on both paths, as one XLA program."""
    return {(fn.__name__, parallel): tuple(fn(ys, A, Q, H, R, M0, P0,
                                              parallel=parallel))
            for fn in (zs.kalman_filter, zs.kalman_smoother)
            for parallel in (False, True)}


@pytest.mark.parametrize("T", [1, 2, 7, 50])
def test_kalman_functions(T):
    ys = YS[:T]
    targs = tuple(_t(a) for a in (ys, A, Q, H, R, M0, P0))
    want = _jax_kalman_all(ys)
    for parallel in (False, True):
        for fn in (tssm.kalman_filter, tssm.kalman_smoother):
            got = fn(*targs, parallel=parallel)
            for g, w in zip(got, want[fn.__name__, parallel]):
                _close(g, w)
    for fn in ("kalman_filter", "kalman_smoother"):
        s = getattr(tssm, fn)(*targs)
        p = getattr(tssm, fn)(*targs, parallel=True)
        for f in ("means", "covs", "log_likelihood"):
            _close(getattr(p, f), getattr(s, f), 1e-9)
    y = _t(YS[0])
    _close(tssm._mvn_logpdf(y, _t(np.ones(1)), _t(R)),
           zs.ssm._mvn_logpdf(jnp.asarray(YS[0]), jnp.ones(1),
                              jnp.asarray(R)))


def test_default_path_follows_the_device():
    """``parallel=None`` (the default) is the sequential loop on CPU
    tensors, bit for bit, and the scan on CUDA tensors."""
    import types

    assert tssm._use_scan(None, types.SimpleNamespace(is_cuda=True))
    assert not tssm._use_scan(None, torch.zeros(1))
    assert tssm._use_scan(True, torch.zeros(1))
    assert not tssm._use_scan(False, types.SimpleNamespace(is_cuda=True))
    targs = tuple(_t(a) for a in _hmm(7, seed=7, impossible=False))
    for fn in (tssm.hmm_filter, tssm.hmm_smoother, tssm.hmm_expected_stats):
        for d, s in zip(fn(*targs), fn(*targs, parallel=False)):
            assert torch.equal(d, s)
    kargs = tuple(_t(a) for a in (YS[:7], A, Q, H, R, M0, P0))
    for fn in (tssm.kalman_filter, tssm.kalman_smoother):
        for d, s in zip(fn(*kargs), fn(*kargs, parallel=False)):
            assert torch.equal(d, s)


def test_parallel_kalman_gradient():
    ys = YS[:8]

    def j_ll(a_mat, q_scale, parallel):
        return zs.kalman_filter(ys, a_mat, q_scale * jnp.eye(2), H, R, M0,
                                P0, parallel=parallel).log_likelihood

    def t_grads(parallel):
        a = _t(A).requires_grad_(True)
        q = torch.tensor(Q_SCALE, dtype=torch.float64, requires_grad=True)
        ll = tssm.kalman_filter(_t(ys), a, q * torch.eye(2, dtype=q.dtype),
                                _t(H), _t(R), _t(M0), _t(P0),
                                parallel=parallel).log_likelihood
        return torch.autograd.grad(ll, (a, q))

    for parallel in (False, True):
        ga, gq = _jit(jax.grad(j_ll, argnums=(0, 1)), static_argnums=2)(
            jnp.asarray(A), jnp.asarray(Q_SCALE), parallel)
        ta, tq = t_grads(parallel)
        _close(ta, ga)
        _close(tq, gq)


def test_associative_scan_matches_cumulative_ops():
    x = torch.arange(1.0, 12.0, dtype=torch.float64)
    for n in (1, 2, 3, 7, 8, 11):
        _close(tssm._associative_scan(torch.add, x[:n]),
               torch.cumsum(x[:n], 0))
        a, b = tssm._associative_scan(
            lambda u, v: (u[0] + v[0], torch.maximum(u[1], v[1])),
            (x[:n], torch.flip(x[:n], [0])))
        _close(a, torch.cumsum(x[:n], 0))
        _close(b, torch.full((n,), float(n)))
        _close(tssm._suffix_scan(torch.add, x[:n]),
               torch.flip(torch.cumsum(torch.flip(x[:n], [0]), 0), [0]))


# -- validation errors, each JAX's message ----------------------------------


def _same_error(j_call, t_call):
    with pytest.raises(Exception) as je:
        j_call()
    with pytest.raises(type(je.value)) as te:
        t_call()
    assert str(te.value) == str(je.value)


def test_validation_errors():
    def j_pf(**kw):
        return zs.ParticleFilter(lambda k, n: jnp.zeros((n, D)),
                                 lambda k, x, t: x, j_emission, **kw)

    def t_pf(**kw):
        return tssm.ParticleFilter(
            lambda g, n: torch.zeros(n, D, dtype=torch.float64),
            lambda g, x, t: x, t_emission, **kw)

    for kw in (dict(n_particles=1),
               dict(n_particles=8, proposal_fn=lambda *a: a[1]),
               dict(n_particles=8, proposal_fn=lambda *a: a[1],
                    proposal_log_prob=lambda *a: 0.0),
               dict(n_particles=8, resample_threshold=1.5)):
        _same_error(lambda: j_pf(**kw), lambda: t_pf(**kw))
    jpf, tpf = j_pf(n_particles=8), t_pf(n_particles=8)
    jy, ty = jnp.asarray(YS[:5]), _t(YS[:5])
    _same_error(lambda: jpf.run(jax.random.PRNGKey(0), {}),
                lambda: tpf.run((0, 0), {}))
    _same_error(lambda: jpf.conditional_run(jax.random.PRNGKey(0), jy,
                                            jnp.zeros((5, D))),
                lambda: tpf.conditional_run((0, 0), ty,
                                            torch.zeros(5, D)))
    jres, tres = jpf.run(jax.random.PRNGKey(0), jy), tpf.run((0, 0), ty)
    _same_error(lambda: jpf.smooth(jax.random.PRNGKey(0), jres, 2),
                lambda: tpf.smooth((0, 0), tres, 2))
    jpf2 = j_pf(n_particles=8, transition_log_prob=j_tlp)
    tpf2 = t_pf(n_particles=8, transition_log_prob=t_tlp)
    _same_error(lambda: jpf2.smooth(jax.random.PRNGKey(0), jres, 2),
                lambda: tpf2.smooth((0, 0), tres, 2))
    bad_j = zs.ParticleFilter(lambda k, n: jnp.zeros((n, D)),
                              lambda k, x, t: x,
                              lambda x, y, t: jnp.zeros((3,)), n_particles=8)
    bad_t = tssm.ParticleFilter(lambda g, n: torch.zeros(n, D),
                                lambda g, x, t: x,
                                lambda x, y, t: torch.zeros(3),
                                n_particles=8)
    _same_error(lambda: bad_j.run(jax.random.PRNGKey(0), jy),
                lambda: bad_t.run((0, 0), ty))
    _same_error(
        lambda: zs.ParticleGibbs(lambda th: jpf).run(
            jax.random.PRNGKey(0), jy, {}, jnp.zeros((5, D)), 1,
            collect_fields=("nope",)),
        lambda: tssm.ParticleGibbs(lambda th: tpf).run(
            (0, 0), ty, {}, torch.zeros(5, D), 1, collect_fields=("nope",)))
    for kw in (dict(step_size=0.0), dict(target_acceptance_rate=1.0)):
        _same_error(lambda: zs.PseudoMarginalMH(None, None, **kw),
                    lambda: tssm.PseudoMarginalMH(None, None, **kw))
    jk = zs.PseudoMarginalMH(None, None)
    tk = tssm.PseudoMarginalMH(None, None)
    _same_error(
        lambda: jk.run(jk.init({"a": jnp.zeros(2)}), jax.random.PRNGKey(0),
                       1, collect_fields=("nope",)),
        lambda: tk.run(tk.init({"a": torch.zeros(2)}), (0, 0), 1,
                       collect_fields=("nope",)))
    lp, lt, lo = _hmm(5, impossible=False)
    for args in ((lp, lt[:3], lo), (lp, lt, lo[:, :3]), (lp, lt, lo[0])):
        _same_error(lambda: zs.hmm_filter(*args),
                    lambda: tssm.hmm_filter(*(_t(a) for a in args)))
    _same_error(lambda: zs.hmm_expected_stats(lp, lt, lo[:1]),
                lambda: tssm.hmm_expected_stats(_t(lp), _t(lt), _t(lo[:1])))
