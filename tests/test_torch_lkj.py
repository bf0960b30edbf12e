"""Parity tests of the port's ``LKJCholesky``
(``zhusuan_tpu_torch/distributions/lkj.py``) against the JAX package's, on
the CPU in float64.

What is held, and to what:

- ``log_prob`` on the JAX package's own samples at d = 2-5 and several
  ``eta`` (``jnp.float64`` on the JAX side: a Python float would make its
  parameters float32), with batch axes and ``group_ndims``, and on
  out-of-support inputs (scaled rows, a non-zero upper triangle, ``|L_21|
  > 1``, a negative diagonal): 1e-12, the same ``-inf`` entries; its
  gradient with respect to ``eta``: 1e-12;
- the sampler (torch's Dirichlet sampler; no ``eps=``): every draw a valid
  correlation Cholesky factor, and every off-diagonal entry of ``L L^T``
  marginally ``2 Beta(a, a) - 1`` with ``a = eta + (d - 2)/2``: mean 0 and
  variance ``1 / (2a + 1)`` within 4 standard errors;
- the JAX tests' checks (``tests/distributions/test_lkj.py``): the d = 2
  closed form, the messages of the error paths;
- ``MeanFieldGuide`` maps an ``LKJCholesky`` latent to
  ``CorrelationCholesky`` (``tests/variational/test_autoguide.py``);
- ``tests/test_bijectors.py:250``'s LKJ prior by HMC (K = 2): the
  correlation's mean and variance from the port's HMC through
  ``CorrelationCholesky``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu import distributions as jzd
from zhusuan_tpu_torch import distributions as tzd
from zhusuan_tpu_torch.bijectors import (
    CorrelationCholesky,
    transform_log_joint,
)
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import HMC
from zhusuan_tpu_torch.variational import MeanFieldGuide

torch.set_num_threads(1)

TOL = 1e-12
SES = 4.0
KEY = jax.random.PRNGKey(17)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _pair(d, eta, group_ndims=0):
    return (jzd.LKJCholesky(d, jnp.float64(eta), group_ndims=group_ndims),
            tzd.LKJCholesky(d, torch.tensor(eta, dtype=torch.float64),
                            group_ndims=group_ndims))


def _bad(d):
    eye = np.eye(d)
    upper = eye.copy()
    upper[0, d - 1] = 0.5
    big = eye.copy()
    big[1, 0], big[1, 1] = 1.5, 0.1
    neg = eye.copy()
    neg[1, 1] = -1.0
    return np.stack([2.0 * eye, upper, big, neg, eye])


@pytest.mark.parametrize("d,eta", [(2, 0.5), (2, 2.5), (3, 1.0), (3, 2.0),
                                   (4, 0.7), (5, 1.5)])
def test_log_prob_on_jax_samples(d, eta):
    jd, td = _pair(d, eta)
    L = np.asarray(jd.sample(jax.random.fold_in(KEY, d), n_samples=40))
    L = np.concatenate([L, _bad(d)])
    want = np.asarray(jd.log_prob(jnp.asarray(L)))
    got = td.log_prob(torch.tensor(L))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(want))
    assert not np.isfinite(want[-5:-1]).any() and np.isfinite(want[-1])
    fin = np.isfinite(want)
    _close(got.numpy()[fin], want[fin])


def test_log_prob_batch_and_group_ndims():
    jd, td = _pair(3, 1.3, group_ndims=1)
    L = np.asarray(jd.sample(KEY, n_samples=12)).reshape(3, 4, 3, 3)
    want = jd.log_prob(jnp.asarray(L))
    got = td.log_prob(torch.tensor(L))
    assert tuple(got.shape) == (3,) == tuple(want.shape)
    _close(got, want)


def test_log_prob_gradient_in_eta():
    d = 4
    L = np.asarray(jzd.LKJCholesky(d, jnp.float64(1.2)).sample(
        KEY, n_samples=8))
    want = jax.grad(lambda e: jnp.sum(
        jzd.LKJCholesky(d, e).log_prob(jnp.asarray(L))))(jnp.float64(1.2))
    eta = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    torch.sum(tzd.LKJCholesky(d, eta).log_prob(torch.tensor(L))).backward()
    _close(eta.grad, want)


@pytest.mark.parametrize("eta", [0.5, 1.0, 2.5])
def test_d2_closed_form(eta):
    td = tzd.LKJCholesky(2, torch.tensor(eta, dtype=torch.float64))
    for r in (-0.8, -0.2, 0.0, 0.5, 0.95):
        L = torch.tensor([[1.0, 0.0], [r, math.sqrt(1 - r * r)]],
                         dtype=torch.float64)
        want = ((eta - 1.0) * math.log(1 - r * r)
                - (2 * eta - 1) * math.log(2.0)
                - (2 * math.lgamma(eta) - math.lgamma(2 * eta)))
        _close(td.log_prob(L), want, 1e-12)


@pytest.mark.parametrize("d,eta", [(2, 1.0), (3, 0.7), (4, 1.5), (5, 2.0)])
def test_sampler_moments_and_support(d, eta):
    td = tzd.LKJCholesky(d, torch.tensor(eta, dtype=torch.float64))
    n = 40000
    L = td.sample(torch.Generator().manual_seed(d), n_samples=n)
    assert tuple(L.shape) == (n, d, d)
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    _close(torch.sum(L * L, -1), np.ones((n, d)), 1e-12)
    corr = L @ L.transpose(-1, -2)
    a = eta + 0.5 * (d - 2)
    var = 1.0 / (2.0 * a + 1.0)
    # The fourth moment of 2 Beta(a, a) - 1: 3 / ((2a + 1)(2a + 3)).
    m4 = 3.0 / ((2 * a + 1) * (2 * a + 3))
    for i in range(d):
        for j in range(i):
            r = corr[:, i, j].numpy()
            assert abs(r.mean()) < SES * math.sqrt(var / n), (i, j)
            assert abs(r.var() - var) < SES * math.sqrt((m4 - var ** 2) / n)
    assert bool(torch.isfinite(td.log_prob(L[:200])).all())


def test_sample_shapes_and_eps():
    td = tzd.LKJCholesky(3, 1.0)
    assert td.dtype == torch.float32
    assert tuple(td.sample(torch.Generator().manual_seed(0)).shape) == (3, 3)
    with pytest.raises(ValueError, match="takes no eps"):
        td.sample(torch.Generator(), 2, eps=torch.zeros(2, 3, 3))
    with pytest.raises(ValueError, match="Generator"):
        td.sample(None, 2)


def test_error_paths():
    with pytest.raises(ValueError, match="d must be"):
        tzd.LKJCholesky(1, 1.0)
    with pytest.raises(ValueError, match="d must be"):
        tzd.LKJCholesky(2.0, 1.0)
    with pytest.raises(ValueError, match="scalar"):
        tzd.LKJCholesky(3, torch.ones(2))
    with pytest.raises(TypeError):
        tzd.LKJCholesky(3, torch.tensor(1))


def test_mean_field_guide_takes_correlation_cholesky():
    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        bn.stochastic("L", tzd.LKJCholesky(3, torch.tensor(
            2.0, dtype=torch.float64)))
        return bn

    g = MeanFieldGuide(model())
    assert type(g.bijectors["L"]).__name__ == "CorrelationCholesky"
    assert tuple(g.init_params()["loc"]["L"].shape) == (3,)


def test_lkj_prior_by_hmc():
    """K = 2 LKJ(eta): the off-diagonal correlation r has (r + 1)/2 ~
    Beta(eta, eta), so Var(r) = 1 / (2 eta + 1); the JAX test's recipe
    and bounds (512 chains, 800 iterations, 300 adaptive)."""
    eta = 2.0
    dist = tzd.LKJCholesky(2, torch.tensor(eta, dtype=torch.float64))
    ulj, to_u, to_c = transform_log_joint(
        lambda obs: dist.log_prob(obs["L"]), {"L": CorrelationCholesky()})
    hmc = HMC(step_size=0.5, n_leapfrogs=5, adapt_step_size=True)
    L0 = torch.eye(2, dtype=torch.float64).expand(512, 2, 2)
    state = hmc.init(to_u({"L": L0}), n_chain_dims=1)
    state, out = hmc.run(ulj, {}, state, (1, 7), n_iters=800, n_adapt=300)
    L = to_c({"L": out["samples"]["L"]})["L"][300:]
    r = (L @ L.transpose(-1, -2))[..., 1, 0].reshape(-1).numpy()
    assert abs(r.mean()) < 0.02, r.mean()
    want_var = 1.0 / (2.0 * eta + 1.0)
    assert abs(r.var() / want_var - 1.0) < 0.08, (r.var(), want_var)
