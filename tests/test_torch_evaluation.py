"""Parity tests of the port's evaluation module
(``zhusuan_tpu_torch/evaluation.py``) against the JAX package, float64 on
the CPU: WAIC, the Pareto-smoothed weights, PSIS-LOO and ``compare`` at
1e-10 (including the ``S < 25`` and constant-tail pass-throughs), the
pointwise log-likelihood at 1e-12 on a pinned model, the AIS schedule and
tempered density at 1e-15, and AIS against the analytic truth at the JAX
package's own test configuration (``tests/test_evaluation.py:53``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu.evaluation as je
import zhusuan_tpu_torch as zt
import zhusuan_tpu_torch.evaluation as te
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net

torch.set_num_threads(1)

TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _ll(seed, s, shape):
    """A pointwise log-likelihood matrix with a few influential points
    (heavy right tails in the LOO ratios)."""
    rs = np.random.RandomState(seed)
    base = -0.5 * rs.randn(s, *shape) ** 2 - rs.uniform(0.5, 2.0, shape)
    flat = base.reshape(s, -1)
    flat[:, :2] -= 3.0 * rs.standard_exponential((s, 2)) ** 1.5
    return flat.reshape(base.shape)


@pytest.mark.parametrize("shape", [(12,), (3, 4)])
def test_waic_matches_jax(shape):
    ll = _ll(0, 400, shape)
    got, want = te.waic(torch.as_tensor(ll)), je.waic(ll)
    for f in got._fields:
        assert tuple(getattr(got, f).shape) == np.shape(getattr(want, f))
        _close(getattr(got, f), getattr(want, f))
    col = ll.reshape(400, -1)[:, :1]  # one data point: se is 0
    assert float(te.waic(torch.as_tensor(col)).se) == float(
        je.waic(col).se) == 0.0


@pytest.mark.parametrize("s", [20, 25, 400, 4000])
def test_psis_smooth_log_weights_match_jax(s):
    rs = np.random.RandomState(s)
    lr = np.concatenate([
        rs.standard_t(2.5, (s, 6)),           # heavy tails
        rs.randn(s, 3),                        # light tails
        np.full((s, 1), 0.7),                  # zero-variation tail
        np.where(np.arange(s)[:, None] < s - 2, 0.0, 1.0),  # two spikes
    ], axis=1)
    got_w, got_k = te.psis_smooth_log_weights(torch.as_tensor(lr))
    want_w, want_k = je.psis_smooth_log_weights(lr)
    np.testing.assert_array_equal(np.isinf(_np(got_k)), np.isinf(want_k))
    np.testing.assert_array_equal(np.sign(_np(got_k))[np.isinf(want_k)],
                                  np.sign(want_k)[np.isinf(want_k)])
    fin = np.isfinite(want_k)
    _close(_np(got_k)[fin], want_k[fin])
    _close(got_w, want_w)
    if s < 25:
        assert np.all(np.isposinf(_np(got_k)))
    else:
        assert np.isneginf(_np(got_k)[9])  # the constant column


def test_psis_chunked_fit_gives_the_unchunked_answer():
    lr = np.random.RandomState(1).standard_t(3.0, (900, 17))
    w1, k1 = te.psis_smooth_log_weights(torch.as_tensor(lr))
    w2, k2 = te.psis_smooth_log_weights(torch.as_tensor(lr), _chunk=1)
    # Only the vectorized reductions' order may differ between chunkings.
    _close(k2, _np(k1), 1e-14)
    _close(w2, _np(w1), 1e-14)


def test_psis_loo_matches_jax():
    ll = _ll(2, 2000, (15,))
    got, want = te.psis_loo(torch.as_tensor(ll)), je.psis_loo(ll)
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f))
    assert np.max(_np(got.pareto_k)) > 0.0


def test_gpd_fit_and_quantile_match_jax():
    rs = np.random.RandomState(3)
    exc = np.sort(rs.pareto(2.0, (60, 5)), axis=0) + 1e-3
    got = te._gpd_fit(torch.as_tensor(exc))
    want = je._gpd_fit(exc)
    for g, w in zip(got, want):
        _close(g, w)
    p = (np.arange(60) + 0.5) / 60
    xi = np.array([0.3, 1e-14, -0.2, 0.8, 0.0])
    sigma = np.array([1.0, 2.0, 0.5, 1.5, 1.0])
    _close(te._gpd_quantile(torch.as_tensor(p), torch.as_tensor(xi),
                            torch.as_tensor(sigma)),
           je._gpd_quantile(p, xi, sigma))


def test_compare_matches_jax_with_the_paired_se():
    lls = {"a": _ll(4, 1000, (20,)), "b": _ll(5, 1000, (20,)) - 0.05,
           "c": _ll(6, 1000, (20,)) - 0.4}
    t_res = {k: te.psis_loo(torch.as_tensor(v)) for k, v in lls.items()}
    j_res = {k: je.psis_loo(v) for k, v in lls.items()}
    t_res["w"] = te.waic(torch.as_tensor(lls["a"]) + 0.01)
    j_res["w"] = je.waic(lls["a"] + 0.01)
    got, want = te.compare(t_res), je.compare(j_res)
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert (g.rank, g.warning) == (w.rank, w.warning)
        for f in ("elpd", "se", "elpd_diff", "dse", "p_eff"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="at least two"):
        te.compare({"a": t_res["a"]})
    with pytest.raises(ValueError, match="same data"):
        te.compare({"a": t_res["a"],
                    "z": te.waic(torch.as_tensor(lls["a"][:, :3]))})
    with pytest.raises(ValueError, match="n_draws, n_data"):
        te.waic(torch.zeros(5))


# --------------------------------------------------------------------- #
# pointwise_log_likelihood on a pinned model (loo_compare's polynomial)
# --------------------------------------------------------------------- #
NOISE = 0.3


def _design(n, degree):
    x = np.linspace(-1.0, 1.0, n)
    return np.stack([x ** d for d in range(degree + 1)], axis=1)


def _j_model(X):
    X_j = jnp.asarray(X)

    @zs.meta_bayesian_net()
    def model():
        bn = zs.BayesianNet()
        w = bn.normal("w", jnp.zeros(X_j.shape[1]), std=jnp.float64(1.0),
                      group_ndims=1)
        bn.normal("y", w.tensor @ X_j.T, std=jnp.float64(NOISE))
        return bn

    return model()


def _t_model(X):
    X_t = torch.as_tensor(X)

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        w = bn.normal("w", torch.zeros(X_t.shape[1], dtype=torch.float64),
                      std=1.0, group_ndims=1)
        bn.normal("y", w.tensor @ X_t.T, std=NOISE)
        return bn

    return model()


def test_pointwise_log_likelihood_matches_jax_on_a_pinned_model():
    X = _design(25, 2)
    rs = np.random.RandomState(7)
    y = rs.randn(25)
    draws = rs.randn(300, 3)
    want = je.pointwise_log_likelihood(
        _j_model(X), {"w": jnp.asarray(draws)}, {"y": jnp.asarray(y)}, "y")
    got = te.pointwise_log_likelihood(
        _t_model(X), {"w": torch.as_tensor(draws)},
        {"y": torch.as_tensor(y)}, "y")
    assert tuple(got.shape) == (300, 25)
    _close(got, want, 1e-12)
    # The per-draw loop (taken with a key) gives the batched answer.
    looped = te.pointwise_log_likelihood(
        _t_model(X), {"w": torch.as_tensor(draws[:20])},
        {"y": torch.as_tensor(y)}, "y", key=torch.Generator().manual_seed(0))
    _close(looped, _np(got)[:20], 1e-12)
    with pytest.raises(ValueError, match="leading n_draws"):
        te.pointwise_log_likelihood(
            _t_model(X), {"w": torch.zeros(3, 3), "v": torch.zeros(4)},
            {"y": torch.as_tensor(y)}, "y")


# --------------------------------------------------------------------- #
# AIS
# --------------------------------------------------------------------- #
SIGMA = 0.6
X_OBS = 1.3
TRUE_LOG_ML = (-0.5 * math.log(2 * math.pi * (1 + SIGMA ** 2))
               - 0.5 * X_OBS ** 2 / (1 + SIGMA ** 2))


def _t_ais(n_chains, n_temperatures, n_adapt=20):
    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        z = bn.normal("z", torch.zeros(n_chains, dtype=torch.float64),
                      std=1.0)
        bn.normal("x", z.tensor, std=SIGMA)
        return bn

    @meta_bayesian_net()
    def proposal():
        bn = BayesianNet()
        bn.normal("z", torch.zeros(n_chains, dtype=torch.float64), std=1.0)
        return bn

    hmc = zt.HMC(step_size=0.3, n_leapfrogs=5, adapt_step_size=True)
    return te.AIS(model(), proposal(), hmc,
                  observed={"x": torch.full((n_chains,), X_OBS,
                                            dtype=torch.float64)},
                  latent=["z"], n_temperatures=n_temperatures,
                  n_adapt=n_adapt)


def _j_ais(n_chains, n_temperatures, n_adapt=20):
    @zs.meta_bayesian_net()
    def model():
        bn = zs.BayesianNet()
        z = bn.normal("z", jnp.zeros(n_chains), std=jnp.float64(1.0))
        bn.normal("x", z.tensor, std=jnp.float64(SIGMA))
        return bn

    @zs.meta_bayesian_net()
    def proposal():
        bn = zs.BayesianNet()
        bn.normal("z", jnp.zeros(n_chains), std=jnp.float64(1.0))
        return bn

    hmc = zs.HMC(step_size=0.3, n_leapfrogs=5, adapt_step_size=True)
    return je.AIS(model(), proposal(), hmc,
                  observed={"x": jnp.full((n_chains,), X_OBS)},
                  latent=["z"], n_temperatures=n_temperatures,
                  n_adapt=n_adapt)


@pytest.mark.parametrize("n_temps", [1, 7, 100, 1000])
def test_ais_schedule_and_tempered_density_match_jax(n_temps):
    t_ais, j_ais = _t_ais(8, n_temps), _j_ais(8, n_temps)
    np.testing.assert_allclose(t_ais._schedule(), j_ais._schedule(),
                               rtol=1e-15, atol=1e-15)
    sched = t_ais._schedule()
    assert sched[0] == 0.0 and sched[-1] == 1.0
    z = np.random.RandomState(n_temps).randn(8)
    obs_t = {"z": torch.as_tensor(z),
             "x": torch.full((8,), X_OBS, dtype=torch.float64)}
    obs_j = {"z": jnp.asarray(z), "x": jnp.full((8,), X_OBS)}
    for temp in (sched[0], sched[min(2, n_temps)], sched[-1], 0.37):
        got = t_ais._tempered_log_fn(torch.tensor(temp,
                                                  dtype=torch.float64))(obs_t)
        want = j_ais._tempered_log_fn(jnp.float64(temp))(obs_j)
        _close(got, want, 1e-15)


def test_ais_matches_the_analytic_truth():
    # tests/test_evaluation.py:53's configuration and tolerance.
    est = _t_ais(200, 100).run(torch.Generator().manual_seed(7))
    assert est.dtype == torch.float64 and est.shape == ()
    np.testing.assert_allclose(float(est), TRUE_LOG_ML, atol=0.05)


def test_ais_single_temperature_and_argument_checks():
    est = float(_t_ais(2000, 1, n_adapt=5).run(
        torch.Generator().manual_seed(0)))
    assert np.isfinite(est)
    assert TRUE_LOG_ML - 1.0 <= est <= TRUE_LOG_ML + 0.1
    with pytest.raises(ValueError, match="n_temperatures"):
        _t_ais(4, 0)
    # One generator state, one estimate.
    a = _t_ais(50, 10, n_adapt=3).run(torch.Generator().manual_seed(1))
    b = _t_ais(50, 10, n_adapt=3).run(torch.Generator().manual_seed(1))
    assert torch.equal(a, b)



# --------------------------------------------------------------------- #
# AIS through the built-in densities (the HMC kernel's route on the card)
# --------------------------------------------------------------------- #
AIS_D = 3
X_VEC = torch.tensor([1.3, -0.4, 0.7], dtype=torch.float64)


def _t_ais_vec(n_chains, n_temperatures, builtins, n_adapt=10,
               target_scale=1.0):
    """``z ~ N(0, I_3)``, ``x | z ~ N(z, SIGMA^2 I)``, one observed ``x``;
    with ``builtins`` the prior ``N(0, I)`` and the posterior ``N(x / (1 +
    SIGMA^2), SIGMA^2 / (1 + SIGMA^2))`` as built-ins (``target_scale``
    widens the latter's std, a wrong target)."""
    zeros = torch.zeros(n_chains, AIS_D, dtype=torch.float64)

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        z = bn.normal("z", zeros, std=1.0, group_ndims=1)
        bn.normal("x", z.tensor, std=SIGMA, group_ndims=1)
        return bn

    @meta_bayesian_net()
    def proposal():
        bn = BayesianNet()
        bn.normal("z", zeros, std=1.0, group_ndims=1)
        return bn

    kwargs = {}
    if builtins:
        post_var = SIGMA ** 2 / (1 + SIGMA ** 2)
        kwargs = dict(
            prior_density=zt.DiagonalGaussianLogJoint(
                "z", torch.zeros(AIS_D, dtype=torch.float64),
                torch.ones(AIS_D, dtype=torch.float64)),
            target_density=zt.DiagonalGaussianLogJoint(
                "z", X_VEC / (1 + SIGMA ** 2),
                torch.full((AIS_D,), target_scale * math.sqrt(post_var),
                           dtype=torch.float64)))
    hmc = zt.HMC(step_size=0.3, n_leapfrogs=5, adapt_step_size=True)
    return te.AIS(model(), proposal(), hmc, observed={"x": X_VEC},
                  latent=["z"], n_temperatures=n_temperatures,
                  n_adapt=n_adapt, **kwargs)


@pytest.mark.parametrize("n_chains,n_temps", [(256, 200), (16, 1)])
def test_ais_builtins_match_the_closures(n_chains, n_temps):
    """Under one key the built-in route gives the closure route's
    estimate at 1e-10 (float64, CPU: both take the plain transition; the
    built-ins drop the normalising constants, which cancel in every
    increment, and the end terms come from the models)."""
    want = _t_ais_vec(n_chains, n_temps, False).run(
        torch.Generator().manual_seed(3))
    got = _t_ais_vec(n_chains, n_temps, True).run(
        torch.Generator().manual_seed(3))
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    if n_temps > 1:
        true = AIS_D * (-0.5 * math.log(2 * math.pi * (1 + SIGMA ** 2)))
        true -= 0.5 * float(torch.sum(X_VEC ** 2)) / (1 + SIGMA ** 2)
        np.testing.assert_allclose(float(got), true, atol=0.1)


def test_ais_builtins_are_checked():
    with pytest.raises(ValueError, match="more than a constant"):
        _t_ais_vec(32, 5, True, target_scale=1.5).run(
            torch.Generator().manual_seed(0))
    prior = zt.DiagonalGaussianLogJoint("z", torch.zeros(AIS_D),
                                        torch.ones(AIS_D))
    base = _t_ais_vec(4, 2, False)
    args = (base._log_joint, base._proposal, base._hmc, {"x": X_VEC})
    with pytest.raises(ValueError, match="go together"):
        te.AIS(*args, latent=["z"], prior_density=prior)
    with pytest.raises(ValueError, match="single latent"):
        te.AIS(*args, latent=["z", "w"], prior_density=prior,
               target_density=prior)
    with pytest.raises(TypeError, match="prior"):
        te.AIS(*args, latent=["z"], prior_density=zt.Toy2DLogJoint("z"),
               target_density=prior)
