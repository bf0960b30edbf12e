"""Parity tests of the five example files the inference-checking slice
ports (``zhusuan_tpu_torch/examples/``: ``toy_examples/evidence_sandwich``,
``model_comparison/loo_compare``, ``sigmoid_belief_nets/sbn_adaptive_is``,
``semi_supervised_vae/{vae_ssl,vae_ssl_adaptive_is}``) against the JAX
package's, in float64 on the CPU at narrow widths: each cost and its
gradients at 1e-10 and chained Adam steps (or an HMC step) at 1e-8, with
the JAX weights (``params_from_numpy``) and the JAX draws fed through
``noise=``: a node's draws come from ``fold_in(key, crc32(name))``,
normals for a Normal node, uniforms for a Bernoulli node, uniforms on
``(tiny, 1)`` for the Gumbels of a OnehotCategorical node."""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
from examples.model_comparison import loo_compare as jloo
from examples.semi_supervised_vae import vae_ssl as jssl
from examples.semi_supervised_vae import vae_ssl_adaptive_is as jssl_is
from examples.sigmoid_belief_nets import sbn as jsbn
from examples.sigmoid_belief_nets import sbn_adaptive_is as jsbn_is
from examples.toy_examples import evidence_sandwich as jsand
from examples.utils import dataset as jdataset
from zhusuan_tpu.evaluation import pointwise_log_likelihood as j_pointwise
from zhusuan_tpu.evaluation import psis_loo as j_psis_loo
from zhusuan_tpu.evaluation import waic as j_waic
from zhusuan_tpu_torch.evaluation import psis_loo, waic
from zhusuan_tpu_torch.examples.model_comparison import loo_compare as tloo
from zhusuan_tpu_torch.examples.semi_supervised_vae import vae_ssl as tssl
from zhusuan_tpu_torch.examples.semi_supervised_vae import (
    vae_ssl_adaptive_is as tssl_is,
)
from zhusuan_tpu_torch.examples.sigmoid_belief_nets import (
    sbn_adaptive_is as tsbn_is,
)
from zhusuan_tpu_torch.examples.toy_examples import evidence_sandwich as tsand
from zhusuan_tpu_torch.examples.utils import dataset as tdataset
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.mcmc import HMC
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
TOL_CHAIN = 1e-8
TINY = float(np.finfo(np.float64).tiny)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _to_torch(jp):
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
    return jp, tnn.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _grads_close(params, jax_grads, tol=TOL):
    assert len(tree_leaves(params)) == len(jax.tree.leaves(jax_grads))
    jax.tree.map(lambda w, t: _close(t.grad, w, tol), jax_grads, params)


def _key(key, name):
    return jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))


def _normal(key, name, shape):
    return torch.tensor(np.asarray(jax.random.normal(_key(key, name), shape,
                                                     jnp.float64)))


def _uniform(key, name, shape, minval=0.0):
    return torch.tensor(np.asarray(jax.random.uniform(
        _key(key, name), shape, jnp.float64, minval=minval, maxval=1.0)))


@pytest.fixture
def jax_float64_scalars(monkeypatch):
    """``BayesianNet.normal`` of the JAX package with Python-float
    parameters passed as float64 (float32 weak types there; the port's
    builders take a ``dtype``)."""
    original = zs.BayesianNet.normal

    def cast(v):
        return jnp.float64(v) if isinstance(v, float) else v

    def normal(self, name, mean=0.0, *args, **kwargs):
        kwargs = {k: cast(v) if k in ("std", "logstd") else v
                  for k, v in kwargs.items()}
        return original(self, name, cast(mean), *args, **kwargs)

    monkeypatch.setattr(zs.BayesianNet, "normal", normal)


# --------------------------------------------------------------------- #
# evidence_sandwich.py
# --------------------------------------------------------------------- #
SAND_K = 16


def _j_sand_cost(kind, params, key):
    model = jsand.build_model(SAND_K)
    q = jsand.build_variational(params, SAND_K, key)
    obs = {"x": jnp.float64(jsand.X0)}
    if kind == "vr":
        return zs.variational.vr_objective(model, obs, variational=q,
                                           axis=0, alpha=0.5).sgvb()
    return zs.variational.cubo_objective(model, obs, variational=q, axis=0,
                                         n=2.0).exp_sgvb()


def _sand_params():
    start = {"mean": 0.3, "logstd": -0.2}
    jp = {k: jnp.float64(v) for k, v in start.items()}
    tp = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in start.items()}
    return jp, tp


@pytest.mark.parametrize("kind", ["vr", "cubo"])
def test_evidence_sandwich_costs_match_jax(jax_float64_scalars, kind):
    jp, tp = _sand_params()
    key = jax.random.PRNGKey(4)
    jcost, jgrads = jax.value_and_grad(
        lambda p: _j_sand_cost(kind, p, key))(jp)
    cost_fn = tsand.vr_cost if kind == "vr" else tsand.cubo_cost
    cost = cost_fn(tp, SAND_K, 0, noise={"z": _normal(key, "z", (SAND_K,))})
    cost.backward()
    _close(cost, jcost)
    for k in jp:
        _close(tp[k].grad, jgrads[k])


@pytest.mark.parametrize("kind", ["vr", "cubo"])
def test_evidence_sandwich_three_adam_steps_match_jax(jax_float64_scalars,
                                                      kind):
    jp, tp = _sand_params()
    n_iters, seed = 3, 5
    jfit = jsand.fit_bound(lambda p, k: _j_sand_cost(kind, p, k), dict(jp),
                           n_iters, seed=seed)
    noise, key = [], jax.random.PRNGKey(seed)
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        noise.append({"z": _normal(sub, "z", (SAND_K,))})
    cost_fn = tsand.vr_cost if kind == "vr" else tsand.cubo_cost
    tfit = tsand.fit_bound(cost_fn, tp, n_iters, SAND_K, seed=seed,
                           noise=noise)
    for k in jp:
        _close(tfit[k], jfit[k], TOL_CHAIN)


def test_evidence_sandwich_main_brackets_log_z():
    out = tsand.main(["--device", "cpu", "--n_iters", "200", "--n_eval",
                      "20000"])
    np.testing.assert_allclose(
        out["log_z"], -0.5 * math.log(4 * math.pi) - 0.25, rtol=1e-12)
    assert out["lower"] <= out["log_z"] + 0.01
    assert out["upper"] >= out["log_z"] - 0.01
    assert 0.0 < out["gap"] < 0.2


# --------------------------------------------------------------------- #
# loo_compare.py
# --------------------------------------------------------------------- #
def test_loo_compare_data_models_and_criteria_match_jax():
    x, y = tloo.make_data()
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(x, np.linspace(-1.0, 1.0, 40))
    np.testing.assert_array_equal(
        y, jloo.make_design(x, 1) @ np.array([0.3, 1.2])
        + jloo.NOISE * rng.randn(40))
    X = tloo.make_design(x, 2)
    np.testing.assert_array_equal(X, jloo.make_design(x, 2))
    draws = np.random.RandomState(1).randn(200, 3) * 0.3
    jm1 = jloo.make_model(X, 1).observe(w=jnp.asarray(draws),
                                        y=jnp.asarray(y))
    tm1 = tloo.make_model(X, 1, torch.float64).observe(
        w=torch.as_tensor(draws), y=torch.as_tensor(y))
    _close(tm1.log_joint(), jm1.log_joint(), 1e-12)
    jll = j_pointwise(jloo.make_model(X, 0), {"w": jnp.asarray(draws)},
                      {"y": jnp.asarray(y)}, node="y")
    from zhusuan_tpu_torch.evaluation import pointwise_log_likelihood
    tll = pointwise_log_likelihood(
        tloo.make_model(X, 0, torch.float64), {"w": torch.as_tensor(draws)},
        {"y": torch.as_tensor(y)}, node="y")
    _close(tll, jll, 1e-12)
    for t_res, j_res in ((psis_loo(tll), j_psis_loo(jll)),
                         (waic(tll), j_waic(jll))):
        for f in t_res._fields:
            _close(getattr(t_res, f), getattr(j_res, f))


def test_loo_compare_hmc_step_matches_jax():
    x, y = tloo.make_data()
    X = tloo.make_design(x, 1)
    c = 8
    jhmc = zs.HMC(step_size=0.1, n_leapfrogs=10, adapt_step_size=True)
    q0 = np.random.RandomState(2).randn(c, 2) * 0.1
    jst = jhmc.init({"w": jnp.asarray(q0)}, n_chain_dims=1)
    key = jax.random.PRNGKey(3)
    jst2, info = jhmc.sample(jloo.make_model(X, 1), {"y": jnp.asarray(y)},
                             jst, key)
    key_p, key_u, _ = jax.random.split(key, 3)
    (kp,) = jax.random.split(key_p, 1)
    eps = torch.tensor(np.asarray(jax.random.normal(kp, (c, 2),
                                                    jnp.float64)))
    u = torch.tensor(np.asarray(jax.random.uniform(key_u, (c,),
                                                   jnp.float64)))
    thmc = HMC(step_size=0.1, n_leapfrogs=10, adapt_step_size=True)
    tst = thmc.init({"w": torch.as_tensor(q0)}, n_chain_dims=1)
    tst2, tinfo = thmc.sample(tloo.make_model(X, 1, torch.float64),
                              {"y": torch.as_tensor(y)}, tst,
                              noise=(eps, u))
    _close(tinfo.acceptance_rate, info.acceptance_rate, TOL_CHAIN)
    _close(tst2.q["w"], jst2.q["w"], TOL_CHAIN)
    _close(tst2.step_size, jst2.step_size, TOL_CHAIN)


def test_loo_compare_fit_and_main_run_small():
    x, y = tloo.make_data()
    loo, wc, draws = tloo.fit_and_score(
        tloo.make_design(x, 1), y, torch.Generator().manual_seed(0),
        n_chains=4, n_iters=60, n_adapt=30, dtype=torch.float64)
    assert tuple(draws.shape) == (30, 4, 2)
    assert tuple(loo.pointwise.shape) == (40,)
    assert np.isfinite(float(loo.elpd_loo)) and np.isfinite(
        float(wc.elpd_waic))
    results, rows = tloo.main(["--device", "cpu", "--n_chains", "8",
                               "--n_iters", "120", "--n_adapt", "60"])
    assert [r.name for r in rows][-1] == "degree 0"


# --------------------------------------------------------------------- #
# sbn_adaptive_is.py
# --------------------------------------------------------------------- #
SBN_X, SBN_H, SBN_N, SBN_K = 16, 8, 6, 4


def _sbn_uniforms(key):
    return {"h1": _uniform(key, "h1", (SBN_K, SBN_N, SBN_H)),
            "h2": _uniform(key, "h2", (1, SBN_K, SBN_N, SBN_H))[0],
            "h3": _uniform(key, "h3", (1, SBN_K, SBN_N, SBN_H))[0]}


def _sbn_data(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(SBN_N, SBN_X) < 0.5).astype(np.float64)


def _sbn_params():
    return _to_torch(jsbn.init_sbn_params(jax.random.PRNGKey(2), SBN_X,
                                          SBN_H))


def test_sbn_adaptive_is_cost_and_gradients_match_jax():
    jp, tp = _sbn_params()
    x = _sbn_data(0)
    key = jax.random.PRNGKey(6)
    (jcost, jlb), jgrads = jax.value_and_grad(
        jsbn_is.combined_cost, has_aux=True)(jp, jnp.asarray(x), key, SBN_H,
                                             SBN_K)
    cost, lb = tsbn_is.combined_cost(tp, torch.tensor(x), 0, SBN_H, SBN_K,
                                     noise=_sbn_uniforms(key))
    cost.backward()
    _close(cost, jcost)
    _close(lb, jlb)
    _grads_close(tp, jgrads)


def test_sbn_adaptive_is_three_adam_steps_match_jax():
    jp, tp = _sbn_params()
    jopt = optax.adam(1e-3, eps=1e-4)
    jstate = jopt.init(jp)

    @jax.jit
    def jstep(params, opt_state, x, key):
        (_, lb), grads = jax.value_and_grad(
            jsbn_is.combined_cost, has_aux=True)(params, x, key, SBN_H,
                                                 SBN_K)
        updates, opt_state = jopt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, lb

    tstep = tsbn_is.make_train_step(
        torch.optim.Adam(tree_leaves(tp), lr=1e-3, eps=1e-4), SBN_H, SBN_K)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(1), 3)):
        x = _sbn_data(10 + i)
        jp, jstate, jlb = jstep(jp, jstate, jnp.asarray(x), key)
        lb = tstep(tp, torch.tensor(x), i, noise=_sbn_uniforms(key))
        _close(lb, jlb, TOL_CHAIN)
    jax.tree.map(lambda w, t: _close(t, w, TOL_CHAIN), jp, tp)


# --------------------------------------------------------------------- #
# semi_supervised_vae/{vae_ssl,vae_ssl_adaptive_is}.py
# --------------------------------------------------------------------- #
SSL_X, SSL_C, SSL_Z, SSL_H, SSL_P, SSL_NL, SSL_NU = 16, 3, 4, 8, 3, 6, 5
BETA = 12.0


def _ssl_params():
    return _to_torch(jssl.init_params(jax.random.PRNGKey(3), SSL_X, SSL_C,
                                      SSL_Z, hidden=SSL_H))


def _ssl_data(seed):
    rng = np.random.RandomState(seed)
    x_l = (rng.rand(SSL_NL, SSL_X) < 0.5).astype(np.float64)
    y_l = np.eye(SSL_C)[rng.randint(0, SSL_C, SSL_NL)]
    x_u = (rng.rand(SSL_NU, SSL_X) < 0.5).astype(np.float64)
    return x_l, y_l, x_u


def _ssl_noise(key, adaptive):
    k_l, k_u = jax.random.split(key)
    noise_l = {"z": _normal(k_l, "z", (SSL_P, SSL_NL, SSL_Z))}
    if adaptive:
        noise_u = {"y": _uniform(k_u, "y", (SSL_NU, SSL_C), minval=TINY),
                   "z": _normal(k_u, "z", (SSL_P, SSL_NU, SSL_Z))}
    else:
        noise_u = {"z": _normal(k_u, "z", (SSL_P, SSL_NU * SSL_C, SSL_Z))}
    return noise_l, noise_u


_SSL = {False: (jssl.ssl_cost, tssl.ssl_cost),
        True: (jssl_is.adaptive_is_cost, tssl_is.adaptive_is_cost)}


@pytest.mark.parametrize("adaptive", [False, True])
def test_semi_supervised_costs_and_gradients_match_jax(adaptive):
    jcost_fn, tcost_fn = _SSL[adaptive]
    jp, tp = _ssl_params()
    x_l, y_l, x_u = _ssl_data(0)
    key = jax.random.PRNGKey(8)
    (jcost, jaux), jgrads = jax.value_and_grad(jcost_fn, has_aux=True)(
        jp, jnp.asarray(x_l), jnp.asarray(y_l), jnp.asarray(x_u), key,
        SSL_C, SSL_Z, SSL_P, BETA)
    cost, aux = tcost_fn(tp, torch.tensor(x_l), torch.tensor(y_l),
                         torch.tensor(x_u), (0, 1), SSL_C, SSL_Z, SSL_P,
                         BETA, noise=_ssl_noise(key, adaptive))
    cost.backward()
    _close(cost, jcost)
    for a, b in zip(aux, jaux):
        _close(a, b)
    _grads_close(tp, jgrads)


@pytest.mark.parametrize("adaptive", [False, True])
def test_semi_supervised_two_adam_steps_match_jax(adaptive):
    jcost_fn, tcost_fn = _SSL[adaptive]
    jp, tp = _ssl_params()
    jopt = optax.adam(3e-4)
    jstate = jopt.init(jp)

    @jax.jit
    def jstep(params, opt_state, x_l, y_l, x_u, key):
        (_, aux), grads = jax.value_and_grad(jcost_fn, has_aux=True)(
            params, x_l, y_l, x_u, key, SSL_C, SSL_Z, SSL_P, BETA)
        updates, opt_state = jopt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, aux

    tstep = tssl.make_train_step(
        tcost_fn, torch.optim.Adam(tree_leaves(tp), lr=3e-4), SSL_C, SSL_Z,
        SSL_P, BETA)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(2), 2)):
        x_l, y_l, x_u = _ssl_data(10 + i)
        jp, jstate, jaux = jstep(jp, jstate, jnp.asarray(x_l),
                                 jnp.asarray(y_l), jnp.asarray(x_u), key)
        stats = tstep(tp, torch.tensor(x_l), torch.tensor(y_l),
                      torch.tensor(x_u), (0, 1),
                      noise=_ssl_noise(key, adaptive))
        _close(stats[:2], np.asarray(jaux[:2], np.float32), 1e-5)
    jax.tree.map(lambda w, t: _close(t, w, TOL_CHAIN), jp, tp)


def test_semi_supervised_loader_and_binarization_match_jax():
    got = tdataset.load_mnist_semi_supervised(n_labeled=100)
    want = jdataset.load_mnist_semi_supervised(n_labeled=100)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    x_u = got[2]
    batches = tssl.binarize_batches(x_u, 100, 3, 4)
    perm = np.random.RandomState(3).permutation(x_u.shape[0])
    for t in range(4):
        rows = x_u[perm[t * 100:(t + 1) * 100]]
        np.testing.assert_array_equal(
            batches[t], (np.random.RandomState(3000 + t).rand(*rows.shape)
                         < rows).astype(np.float32))
