"""Parity tests of the port's inclusive KL (``klpq``) and Renyi / chi upper
bound objectives (``zhusuan_tpu_torch/variational/{inclusive_kl,renyi}.py``)
against the JAX package, in float64 on the CPU: values and gradients at
1e-10 on the same reparameterized draws, and the properties of the JAX
package's ``tests/variational/test_renyi.py`` (alpha = 0 is IWAE, the
alpha = 1 limit, monotone in alpha, the evidence sandwich).

Conjugate setup: z ~ N(0, 1), x | z ~ N(z, 1), x0 = 1, so log Z =
log N(1; 0, sqrt 2)."""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.variational import (
    cubo_objective as j_cubo,
    klpq as j_klpq,
    vr_objective as j_vr,
)
from zhusuan_tpu_torch.variational import (
    ChiSquareObjective,
    InclusiveKLObjective,
    RenyiDivergenceObjective,
    cubo_objective as t_cubo,
    importance_weighted_objective as t_iw,
    klpq as t_klpq,
    vr_objective as t_vr,
)

torch.set_num_threads(1)

X0 = 1.0
LOG_Z = -0.5 * math.log(2 * math.pi * 2.0) - X0 ** 2 / 4.0
TOL = 1e-10


def _log_normal(x, mean, logstd, lib):
    return (-0.5 * math.log(2 * math.pi) - logstd
            - 0.5 * ((x - mean) / lib.exp(logstd)) ** 2)


def j_log_joint(obs):
    z = obs["z"]
    return (_log_normal(z, 0.0, jnp.float64(0.0), jnp)
            + _log_normal(jnp.float64(X0), z, jnp.float64(0.0), jnp))


def t_log_joint(obs):
    z = obs["z"]
    zero = torch.zeros((), dtype=torch.float64)
    return (_log_normal(z, 0.0, zero, torch)
            + _log_normal(torch.tensor(X0, dtype=torch.float64), z, zero,
                          torch))


def _eps(k, batch=(3,), seed=0):
    return np.random.RandomState(seed).randn(k, *batch)


def _j_latent(params, eps):
    mean, logstd = params
    z = mean + jnp.exp(logstd) * eps
    return {"z": (z, _log_normal(z, mean, logstd, jnp))}


def _t_latent(params, eps):
    mean, logstd = params
    z = mean + torch.exp(logstd) * eps
    return {"z": (z, _log_normal(z, mean, logstd, torch))}


PARAMS = (np.array([0.2, -0.4, 0.9]), np.array([0.1, -0.3, 0.4]))


def _both(j_cost, t_cost, eps):
    """Value and gradient w.r.t. (mean, logstd) of a scalar cost in both
    packages."""
    jp = tuple(jnp.asarray(p) for p in PARAMS)
    j_val, j_grad = jax.value_and_grad(
        lambda p: j_cost(_j_latent(p, jnp.asarray(eps))))(jp)
    tp = tuple(torch.tensor(p, requires_grad=True) for p in PARAMS)
    t_val = t_cost(_t_latent(tp, torch.as_tensor(eps)))
    t_grad = torch.autograd.grad(t_val, tp)
    np.testing.assert_allclose(float(t_val.detach()), float(j_val),
                               rtol=TOL,
                               atol=TOL)
    for g, w in zip(t_grad, j_grad):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    return float(t_val.detach())


@pytest.mark.parametrize("k", [1, 16])
def test_klpq_importance_value_and_gradient_match_jax(k):
    eps = _eps(k)
    _both(lambda lat: jnp.sum(j_klpq(j_log_joint, {}, latent=lat,
                                     axis=0).importance()),
          lambda lat: torch.sum(t_klpq(t_log_joint, {}, latent=lat,
                                       axis=0).importance()), eps)


def test_klpq_single_sample_warning_rws_alias_and_no_value():
    eps = _eps(4)
    tp = tuple(torch.tensor(p) for p in PARAMS)
    obj = t_klpq(t_log_joint, {}, latent=_t_latent(tp, torch.as_tensor(
        eps[0])))
    assert isinstance(obj, InclusiveKLObjective)
    with pytest.warns(UserWarning, match="single sample"):
        single = obj.importance()
    assert torch.equal(single, obj._entropy_term())
    obj = t_klpq(t_log_joint, {}, latent=_t_latent(tp, torch.as_tensor(eps)),
                 axis=0)
    with pytest.warns(FutureWarning, match="importance"):
        via_rws = obj.rws()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(via_rws, obj.importance())
    with pytest.raises(NotImplementedError, match="only be optimized"):
        obj.tensor
    # The self-normalized weights are constants: only the entropy term's
    # gradient flows (the weights do not depend on the model here).
    jp = tuple(jnp.asarray(p) for p in PARAMS)
    with pytest.raises(NotImplementedError):
        j_klpq(j_log_joint, {}, latent=_j_latent(jp, jnp.asarray(eps)),
               axis=0).tensor


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_vr_objective_values_and_gradients_match_jax(alpha):
    eps = _eps(32, seed=1)
    _both(lambda lat: jnp.sum(j_vr(j_log_joint, {}, latent=lat, axis=0,
                                   alpha=alpha).sgvb()),
          lambda lat: torch.sum(t_vr(t_log_joint, {}, latent=lat, axis=0,
                                     alpha=alpha).sgvb()), eps)
    _both(lambda lat: jnp.sum(j_vr(j_log_joint, {}, latent=lat, axis=0,
                                   alpha=alpha).tensor),
          lambda lat: torch.sum(t_vr(t_log_joint, {}, latent=lat, axis=0,
                                     alpha=alpha).tensor), eps)


@pytest.mark.parametrize("n", [1.0, 2.0, 3.5])
def test_cubo_sgvb_and_exp_sgvb_match_jax(n):
    eps = _eps(32, seed=2)
    for method in ("sgvb", "exp_sgvb"):
        _both(lambda lat: jnp.sum(getattr(j_cubo(
                  j_log_joint, {}, latent=lat, axis=0, n=n), method)()),
              lambda lat: torch.sum(getattr(t_cubo(
                  t_log_joint, {}, latent=lat, axis=0, n=n), method)()),
              eps)


def test_exp_sgvb_uses_one_global_shift():
    # Batch elements far apart in scale: a per-element shift would
    # reweight them; the global one keeps the gradient proportional to
    # the surrogate's.
    eps = _eps(8, batch=(2,), seed=3)
    tp = (torch.tensor([0.0, 6.0], dtype=torch.float64, requires_grad=True),
          torch.tensor([0.0, 0.0], dtype=torch.float64, requires_grad=True))
    obj = t_cubo(t_log_joint, {}, latent=_t_latent(tp, torch.as_tensor(eps)),
                 axis=0, n=2.0)
    cost = obj.exp_sgvb()
    log_w = (obj._log_joint_term() + obj._entropy_term()).detach()
    want = torch.mean(torch.exp(2.0 * log_w), 0) / torch.exp(
        torch.amax(2.0 * log_w))
    torch.testing.assert_close(cost.detach(), want, rtol=1e-12, atol=0)


def test_argument_checks():
    lat = {"z": (torch.zeros(4), torch.zeros(4))}
    with pytest.raises(ValueError, match="axis"):
        t_vr(t_log_joint, {}, latent=lat)
    with pytest.raises(ValueError, match="axis"):
        t_cubo(t_log_joint, {}, latent=lat)
    with pytest.raises(ValueError, match="n >= 1"):
        t_cubo(t_log_joint, {}, latent=lat, axis=0, n=0.5)
    assert t_vr(t_log_joint, {}, latent=lat, axis=0, alpha=0.3).alpha == 0.3
    assert t_cubo(t_log_joint, {}, latent=lat, axis=0, n=3).n == 3.0
    assert isinstance(t_vr(t_log_joint, {}, latent=lat, axis=0),
                      RenyiDivergenceObjective)
    assert isinstance(t_cubo(t_log_joint, {}, latent=lat, axis=0),
                      ChiSquareObjective)


# --------------------------------------------------------------------- #
# tests/variational/test_renyi.py's properties, on the port
# --------------------------------------------------------------------- #
def _q(mean, logstd, k, seed=3):
    eps = torch.as_tensor(np.random.RandomState(seed).randn(k))
    m = torch.tensor(mean, dtype=torch.float64)
    s = torch.tensor(logstd, dtype=torch.float64)
    return _t_latent((m, s), eps)


def test_alpha0_equals_iwae():
    lat = _q(0.2, 0.1, 64)
    vr = t_vr(t_log_joint, {}, latent=lat, axis=0, alpha=0.0)
    iw = t_iw(t_log_joint, {}, latent=lat, axis=0)
    np.testing.assert_allclose(float(vr.tensor), float(iw.tensor),
                               rtol=1e-12)


def test_alpha1_is_the_elbo_limit():
    lat = _q(0.2, 0.1, 200_000)
    one = t_vr(t_log_joint, {}, latent=lat, axis=0, alpha=1.0)
    near = t_vr(t_log_joint, {}, latent=lat, axis=0, alpha=1.0 - 1e-6)
    np.testing.assert_allclose(float(one.tensor), float(near.tensor),
                               rtol=0, atol=1e-4)


def test_monotone_nonincreasing_in_alpha():
    lat = _q(0.9, 0.4, 100_000)
    vals = [float(t_vr(t_log_joint, {}, latent=lat, axis=0,
                       alpha=a).tensor)
            for a in (-1.0, 0.0, 0.5, 1.0, 2.0)]
    assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:])), vals


def test_the_evidence_sandwich_at_the_exact_posterior_and_off_it():
    post = (0.5, 0.5 * math.log(0.5))
    lat = _q(*post, 100_000)
    for alpha in (0.0, 0.5, 1.0):
        v = float(t_vr(t_log_joint, {}, latent=lat, axis=0,
                       alpha=alpha).tensor)
        np.testing.assert_allclose(v, LOG_Z, atol=1e-8)  # w constant
    lat = _q(0.9, 0.4, 200_000)
    lower = float(t_vr(t_log_joint, {}, latent=lat, axis=0,
                       alpha=0.5).tensor)
    upper = float(t_cubo(t_log_joint, {}, latent=lat, axis=0,
                         n=2.0).tensor)
    assert lower < LOG_Z < upper
