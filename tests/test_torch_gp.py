"""Parity of the port's Gaussian processes (``zhusuan_tpu_torch/gp.py``)
with ``zhusuan_tpu/gp.py``, in float64 on the CPU, on inputs made with
numpy from a seed: every kernel's Gram matrix and diagonal, the exact
log-marginal and its gradient, exact and sparse regression, and the SVGP
bound and predictions under the three likelihoods, at 1e-10; the
Gauss-Hermite expectation at 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu import gp as jgp
from zhusuan_tpu_torch import gp as tgp

torch.set_num_threads(1)

TOL = 1e-10
RNG = np.random.default_rng(0)
X = RNG.standard_normal((9, 3))
Z = RNG.standard_normal((5, 3))
XS = RNG.standard_normal((4, 3))
Y = np.sin(X @ np.array([1.0, -0.5, 0.3])) + 0.1 * RNG.standard_normal(9)
ELL = np.array([0.7, 1.3, 2.0])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64,
                        requires_grad=grad)


def _kernels(m, arr, f64):
    """The kernel zoo under module ``m``; ``arr`` makes arrays, ``f64``
    scalars (``jnp.float64`` on the JAX side: a Python float is weak)."""
    ell = arr(ELL)
    return {
        "rbf": m.RBF(ell, f64(1.7)),
        "matern12": m.Matern12(ell, f64(0.8)),
        "matern32": m.Matern32(f64(1.1), f64(1.4)),
        "matern52": m.Matern52(ell, f64(2.1)),
        "periodic": m.Periodic(f64(0.9), f64(1.6), f64(1.2)),
        "rq": m.RationalQuadratic(ell, f64(0.6), f64(2.5)),
        "linear": m.Linear(f64(0.4), f64(0.2)),
        "constant": m.Constant(f64(0.3)),
        "sum": m.RBF(ell, f64(1.0)) + m.Linear(f64(0.2)),
        "product": m.Matern32(ell, f64(1.5)) * m.Periodic(f64(1.0),
                                                          f64(2.0)),
    }


def _jk():
    return _kernels(jgp, jnp.asarray, jnp.float64)


def _tk():
    return _kernels(tgp, _t, lambda v: torch.tensor(v, dtype=torch.float64))


@pytest.mark.parametrize("name", sorted(_jk()))
def test_kernel_gram_and_diag(name):
    jk, tk = _jk()[name], _tk()[name]
    _close(tk(_t(X), _t(Z)), jk(X, Z))
    _close(tk(_t(X), _t(X)), jk(X, X))
    _close(tk.kdiag(_t(XS)), jk.kdiag(XS))


def test_python_number_hyperparameters():
    # Python numbers take the inputs' dtype, as JAX's weak scalars do.
    got = tgp.RBF(0.8, 1.3)(_t(X), _t(Z))
    assert got.dtype == torch.float64
    _close(got, jgp.RBF(0.8, 1.3)(X, Z))


def _hyper():
    return {"log_ell": np.log(ELL), "log_var": np.float64(0.2),
            "log_noise": np.float64(-1.5)}


def test_gp_log_marginal_and_gradient():
    def jloss(p):
        k = jgp.RBF(jnp.exp(p["log_ell"]), jnp.exp(p["log_var"]))
        return jgp.gp_log_marginal(k, X, Y, jnp.exp(p["log_noise"]))

    p = _hyper()
    want, want_g = jax.value_and_grad(jloss)(p)
    tp = {k: _t(v, grad=True) for k, v in p.items()}
    got = tgp.gp_log_marginal(
        tgp.RBF(torch.exp(tp["log_ell"]), torch.exp(tp["log_var"])),
        _t(X), _t(Y), torch.exp(tp["log_noise"]))
    got.backward()
    _close(got, want)
    for k in p:
        _close(tp[k].grad, want_g[k])


@pytest.mark.parametrize("full_cov", [False, True])
def test_gp_regression(full_cov):
    want = jgp.gp_regression(_jk()["matern52"], X, Y, XS, jnp.float64(0.1),
                             full_cov=full_cov)
    got = tgp.gp_regression(_tk()["matern52"], _t(X), _t(Y), _t(XS),
                            torch.tensor(0.1, dtype=torch.float64),
                            full_cov=full_cov)
    for g, w in zip(got, want):
        _close(g, w)


def test_sgpr_elbo_gradient_in_inducing_inputs():
    def jloss(z, log_noise):
        return jgp.sgpr_elbo(jgp.RBF(jnp.asarray(ELL), jnp.float64(1.2)),
                             X, Y, z, jnp.exp(log_noise))

    want, (gz, gn) = jax.value_and_grad(jloss, argnums=(0, 1))(
        Z, np.float64(-1.0))
    z, log_noise = _t(Z, grad=True), _t(-1.0, grad=True)
    got = tgp.sgpr_elbo(tgp.RBF(_t(ELL), torch.tensor(1.2,
                                                      dtype=torch.float64)),
                        _t(X), _t(Y), z, torch.exp(log_noise))
    got.backward()
    _close(got, want)
    _close(z.grad, gz)
    _close(log_noise.grad, gn)


def test_sgpr_predict():
    want = jgp.sgpr_predict(_jk()["sum"], X, Y, Z, XS, jnp.float64(0.2))
    got = tgp.sgpr_predict(_tk()["sum"], _t(X), _t(Y), _t(Z), _t(XS),
                           torch.tensor(0.2, dtype=torch.float64))
    for g, w in zip(got, want):
        _close(g, w)
    # The bound it carries is sgpr_elbo's.
    _close(got.log_marginal, jgp.sgpr_elbo(_jk()["sum"], X, Y, Z,
                                           jnp.float64(0.2)))


def _svgp_state():
    m = Z.shape[0]
    rng = np.random.default_rng(7)
    return jgp.SVGPState(z=Z, q_mu=rng.standard_normal(m),
                         q_sqrt=np.eye(m) + 0.3 * rng.standard_normal((m, m)))


def _likelihoods(y):
    return {
        "gaussian": (jgp.GaussianLikelihood(jnp.float64(0.3)),
                     tgp.GaussianLikelihood(torch.tensor(
                         0.3, dtype=torch.float64)), y),
        "bernoulli": (jgp.BernoulliLikelihood(12),
                      tgp.BernoulliLikelihood(12), (y > 0).astype(float)),
        "poisson": (jgp.PoissonLikelihood(), tgp.PoissonLikelihood(),
                    np.floor(np.exp(y))),
    }


@pytest.mark.parametrize("lik", ["gaussian", "bernoulli", "poisson"])
def test_svgp_elbo_predict_and_gradient(lik):
    jl, tl, y = _likelihoods(Y)[lik]
    state = _svgp_state()

    def jloss(s):
        return jgp.svgp_elbo(_jk()["rbf"], s, X, y, jl, n_data=40)

    want, want_g = jax.value_and_grad(jloss)(state)
    ts = tgp.svgp_state_from_numpy(state, device="cpu")
    got = tgp.svgp_elbo(_tk()["rbf"], ts, _t(X), _t(y), tl, n_data=40)
    got.backward()
    _close(got, want)
    for g, w in zip(ts, want_g):
        _close(g.grad, w)
    with torch.no_grad():
        pred = tgp.svgp_predict(_tk()["rbf"], ts, _t(XS), tl)
    wpred = jgp.svgp_predict(_jk()["rbf"], state, XS, jl)
    _close(pred.mean, wpred.mean)
    _close(pred.var, wpred.var)
    assert np.isnan(_np(pred.log_marginal))
    fm, fv = tgp.svgp_marginals(_tk()["rbf"], ts, _t(XS))
    wm, wv = jgp.svgp_marginals(_jk()["rbf"], state, XS)
    _close(fm, wm)
    _close(fv, wv)


def test_svgp_init_and_state_round_trip():
    st = tgp.svgp_init(_t(Z), jitter_scale=0.5)
    jst = jgp.svgp_init(Z, jitter_scale=0.5)
    for g, w in zip(st, jst):
        _close(g, w, 0.0)
    back = tgp.svgp_state_from_numpy(tgp.svgp_state_to_numpy(st),
                                     device="cpu")
    for g, w in zip(back, st):
        assert torch.equal(g.detach(), w) and g.requires_grad
    # The prior state's bound is the prior expected log-likelihood.
    lik = tgp.GaussianLikelihood(0.5)
    elbo = tgp.svgp_elbo(_tk()["rbf"], st._replace(q_sqrt=torch.eye(
        5, dtype=torch.float64)), _t(X), _t(Y), lik)
    assert torch.isfinite(elbo)


@pytest.mark.parametrize("n_quad", [5, 20])
def test_gauss_hermite(n_quad):
    mu = RNG.standard_normal(6)
    var = np.abs(RNG.standard_normal(6))
    var[0] = 0.0
    want = jgp._gauss_hermite(jnp.tanh, mu, var, n_quad)
    got = tgp._gauss_hermite(torch.tanh, _t(mu), _t(var), n_quad)
    _close(got, want, 1e-10)
    # Exact for a quadratic: E[f^2] = mu^2 + var.
    got2 = tgp._gauss_hermite(torch.square, _t(mu), _t(var), n_quad)
    _close(got2, mu ** 2 + var, 1e-10)
