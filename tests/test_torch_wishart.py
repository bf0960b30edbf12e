"""Parity tests of the port's ``Wishart``
(``zhusuan_tpu_torch/distributions/wishart.py``) against the JAX package's
and ``scipy.stats.wishart``, on the CPU in float64.

What is held, and to what:

- ``log_prob`` on the JAX package's own samples at d = 2-5 and several
  ``df``, with batch axes and ``group_ndims``: against the JAX package at
  1e-12 and against ``scipy.stats.wishart.logpdf`` at 1e-10;
- off the PD cone (an indefinite matrix, a negative definite one, a
  non-symmetric one whose symmetric part is indefinite, a NaN entry):
  ``-inf`` as the JAX package scores it (its Cholesky is NaN there; the
  port's ``cholesky_ex`` reports the failure and nothing raises); a
  non-symmetric input is symmetrized first, as ``jnp.linalg.cholesky``
  does;
- the gradient of ``log_prob`` with respect to the scale: 1e-10;
- the Bartlett sampler (torch's gamma sampler; no ``eps=``): ``E[W] = df
  S`` and ``Var[W_ij] = df (S_ij^2 + S_ii S_jj)`` within 4 standard
  errors, every draw PD;
- the JAX tests' error paths (``tests/distributions/test_wishart.py``),
  and ``MeanFieldGuide`` raising on a Wishart latent
  (``tests/variational/test_autoguide.py:162``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from zhusuan_tpu import distributions as jzd
from zhusuan_tpu_torch import distributions as tzd
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.variational import MeanFieldGuide

torch.set_num_threads(1)

TOL = 1e-12
SES = 4.0
KEY = jax.random.PRNGKey(13)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _scale(d, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(d, d) * 0.4
    return np.eye(d) + a @ a.T


@pytest.mark.parametrize("d,df", [(2, 2.0), (2, 3.0), (3, 5.5), (4, 8.0),
                                  (5, 5.0)])
def test_log_prob_against_jax_and_scipy(d, df):
    s = _scale(d, d)
    jd = jzd.Wishart(df, jnp.asarray(s))
    td = tzd.Wishart(df, torch.tensor(s))
    x = np.asarray(jd.sample(jax.random.fold_in(KEY, d), n_samples=16))
    want = np.asarray(jd.log_prob(jnp.asarray(x)))
    got = td.log_prob(torch.tensor(x))
    _close(got, want)
    _close(got, stats.wishart(df=df, scale=s).logpdf(
        np.transpose(x, (1, 2, 0))), 1e-10)


def test_log_prob_batch_and_group_ndims():
    s = _scale(3)
    jd = jzd.Wishart(4.0, jnp.asarray(s), group_ndims=1)
    td = tzd.Wishart(4.0, torch.tensor(s), group_ndims=1)
    x = np.asarray(jd.sample(KEY, n_samples=6)).reshape(2, 3, 3, 3)
    got = td.log_prob(torch.tensor(x))
    assert tuple(got.shape) == (2,)
    _close(got, jd.log_prob(jnp.asarray(x)))


def test_off_the_pd_cone_is_neg_inf_as_in_jax():
    s = _scale(3)
    jd = jzd.Wishart(4.0, jnp.asarray(s))
    td = tzd.Wishart(4.0, torch.tensor(s))
    good = np.asarray(jd.sample(KEY, n_samples=1))[0]
    indefinite = np.eye(3)
    indefinite[0, 1] = indefinite[1, 0] = 2.0
    skew = good.copy()
    skew[0, 2] += 9.0
    skew[2, 0] -= 9.0  # symmetric part = good: PD
    skew_bad = np.eye(3)
    skew_bad[0, 1], skew_bad[1, 0] = 5.0, -1.0  # symmetric part indefinite
    nan = good.copy()
    nan[1, 1] = np.nan
    x = np.stack([good, indefinite, -np.eye(3), skew, skew_bad, nan])
    want = np.asarray(jd.log_prob(jnp.asarray(x)))
    got = td.log_prob(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isneginf(got),
                                  [False, True, True, False, True, True])
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


def test_gradient_in_scale():
    s = _scale(3, 5)
    x = np.asarray(jzd.Wishart(6.0, jnp.asarray(s)).sample(KEY, 8))
    want = jax.grad(lambda m: jnp.sum(jzd.Wishart(6.0, m).log_prob(
        jnp.asarray(x))))(jnp.asarray(s))
    st = torch.tensor(s, requires_grad=True)
    torch.sum(tzd.Wishart(6.0, st).log_prob(torch.tensor(x))).backward()
    _close(st.grad, want, 1e-10)


@pytest.mark.parametrize("d,df", [(2, 3.0), (3, 6.0)])
def test_sampler_moments(d, df):
    s = _scale(d, 2)
    td = tzd.Wishart(df, torch.tensor(s))
    n = 40000
    w = td.sample(torch.Generator().manual_seed(d), n_samples=n).numpy()
    assert np.linalg.eigvalsh(w).min() > 0
    mean, var = df * s, df * (s ** 2 + np.outer(np.diag(s), np.diag(s)))
    c = w - w.mean(0)
    m4 = (c ** 4).mean(0)
    assert (np.abs(w.mean(0) - mean) < SES * np.sqrt(var / n)).all()
    assert (np.abs(w.var(0) - var)
            < SES * np.sqrt((m4 - w.var(0) ** 2) / n)).all()
    assert np.isfinite(td.log_prob(torch.tensor(w[:100])).numpy()).all()


def test_sampler_draws_no_eps():
    td = tzd.Wishart(4.0, torch.eye(2))
    with pytest.raises(ValueError, match="takes no eps"):
        td.sample(torch.Generator(), 2, eps=torch.zeros(2, 2, 2))
    assert tuple(td.sample(torch.Generator()).shape) == (2, 2)


def test_error_paths():
    with pytest.raises(ValueError, match="square"):
        tzd.Wishart(4.0, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="df"):
        tzd.Wishart(1.5, torch.eye(3, dtype=torch.float64))
    # A non-PD scale gives a NaN factor, as the JAX package's Cholesky.
    bad = tzd.Wishart(3.0, -torch.eye(2, dtype=torch.float64))
    assert math.isnan(float(bad.log_prob(torch.eye(2, dtype=torch.float64))))


def test_mean_field_guide_raises_on_wishart():
    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        bn.stochastic("S", tzd.Wishart(5.0, torch.eye(2)))
        return bn

    with pytest.raises(ValueError, match="PD-matrix"):
        MeanFieldGuide(model())
