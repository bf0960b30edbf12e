"""Parity tests of the port's ``Mixture`` (``zhusuan_tpu_torch/
distributions/mixture.py``) and ``BayesianNet.mixture`` against the JAX
package's, on the CPU in float64.

- ``log_prob`` (with ``group_ndims``, batched logits and components,
  multivariate and discrete components) at 1e-12, and its gradients with
  respect to the logits and the components' parameters;
- samples fed the JAX draws: the components' base normals from
  ``split(key) -> key_comp, key_cat`` and the assignment's Gumbel uniforms
  ``uniform(key_cat, [n] + batch + [K], minval=tiny)``, through
  ``eps=(comp_eps, u)``: the same samples at 1e-12;
- the JAX tests' checks (``tests/distributions/test_mixture.py``) with
  their messages, and the ``mixture`` sugar method's node.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu import distributions as jzd
from zhusuan_tpu_torch import distributions as tzd
from zhusuan_tpu_torch.framework import BayesianNet

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)
TINY = float(np.finfo(np.float64).tiny)
RNG = np.random.RandomState(4)
W = np.array([0.2, 0.5, 0.3])
MU = np.array([-3.0, 0.5, 4.0])
SD = np.array([0.6, 1.0, 2.0])


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _normal_mixture(m, t, logits, mu, sd, **kw):
    return m.Mixture(t(logits), m.Normal(t(mu), std=t(sd)), **kw)


def _mvn_mixture(m, t, logits, mu, tril, **kw):
    return m.Mixture(t(logits), m.MultivariateNormalCholesky(t(mu), t(tril)),
                     **kw)


TRIL = np.tril(RNG.randn(3, 2, 2) * 0.3, -1) + np.eye(2) * 1.2
# (builder, arguments, values to score, group_ndims)
CASES = [
    ("scalar", _normal_mixture, (np.log(W), MU, SD),
     np.linspace(-6.0, 8.0, 11), 0),
    ("batched", _normal_mixture, (RNG.randn(4, 3), RNG.randn(4, 3),
                                  0.5 + RNG.rand(4, 3)),
     RNG.randn(5, 4), 1),
    ("broadcast_logits", _normal_mixture, (np.log(W), RNG.randn(4, 3),
                                           0.5 + RNG.rand(4, 3)),
     RNG.randn(2, 4), 0),
    ("mvn", _mvn_mixture, (np.log(W), RNG.randn(3, 2), TRIL),
     RNG.randn(6, 2), 0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_log_prob_and_gradients_match_jax(case):
    _, build, args, x, group_ndims = case
    jd = build(jzd, jnp.asarray, *args, group_ndims=group_ndims)
    td = build(tzd, torch.tensor, *args, group_ndims=group_ndims)
    assert tuple(td.batch_shape) == tuple(jd.batch_shape)
    assert tuple(td.value_shape) == tuple(jd.value_shape)
    assert td.n_components == jd.n_components
    assert not td.is_reparameterized
    _close(td.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)))
    _close(td.prob(torch.tensor(x)), jd.prob(jnp.asarray(x)))

    def jax_lp(*params):
        return jnp.sum(build(jzd, jnp.asarray, *params,
                             group_ndims=group_ndims).log_prob(
            jnp.asarray(x)))

    want = jax.grad(jax_lp, argnums=(0, 1, 2))(*[jnp.asarray(a)
                                                 for a in args])
    params = [torch.tensor(a.copy(), requires_grad=True) for a in args]
    build(tzd, lambda v: v, *params, group_ndims=group_ndims).log_prob(
        torch.tensor(x)).sum().backward()
    for p, w in zip(params, want):
        _close(p.grad, w, 1e-10)


def test_discrete_components_match_jax():
    rate = 0.5 + RNG.rand(2, 3) * 4.0
    logits = RNG.randn(2, 3)
    x = np.array([[0, 3], [5, 1], [2, 2]])
    jd = jzd.Mixture(jnp.asarray(logits), jzd.Poisson(jnp.asarray(rate)))
    td = tzd.Mixture(torch.tensor(logits), tzd.Poisson(torch.tensor(rate)))
    assert td.dtype == torch.int32 and not td.is_continuous
    _close(td.log_prob(torch.tensor(x, dtype=torch.int32)),
           jd.log_prob(jnp.asarray(x, jnp.int32)), 1e-10)


@pytest.mark.parametrize("n_samples", [None, 5])
@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "mvn"],
                         ids=lambda c: c[0])
def test_sample_from_jax_draws_matches_jax(case, n_samples):
    _, build, args, _, _ = case
    jd = build(jzd, jnp.asarray, *args)
    td = build(tzd, torch.tensor, *args)
    want = np.asarray(jd.sample(KEY, n_samples=n_samples))
    key_comp, key_cat = jax.random.split(KEY)
    n = n_samples or 1
    full = np.broadcast_shapes(np.shape(args[0]), np.shape(args[1]))
    comp_eps = np.asarray(jax.random.normal(key_comp, (n,) + full,
                                            jnp.float64))
    u = np.asarray(jax.random.uniform(key_cat, (n,) + full, jnp.float64,
                                      minval=TINY, maxval=1.0))
    if n_samples is None:
        comp_eps, u = comp_eps[0], u[0]
    got = td.sample(n_samples=n_samples,
                    eps=(torch.tensor(comp_eps), torch.tensor(u)))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_mvn_sample_from_jax_draws_matches_jax():
    _, build, args, _, _ = CASES[3]
    jd = build(jzd, jnp.asarray, *args)
    td = build(tzd, torch.tensor, *args)
    want = np.asarray(jd.sample(KEY, n_samples=4))
    key_comp, key_cat = jax.random.split(KEY)
    comp_eps = jax.random.normal(key_comp, (4, 3, 2), jnp.float64)
    u = jax.random.uniform(key_cat, (4, 3), jnp.float64, minval=TINY,
                           maxval=1.0)
    got = td.sample(n_samples=4, eps=(torch.tensor(np.asarray(comp_eps)),
                                      torch.tensor(np.asarray(u))))
    _close(got, want)


def test_sample_moments_from_torch_generator():
    td = _normal_mixture(tzd, torch.tensor, np.log(W), MU, SD)
    x = td.sample(torch.Generator().manual_seed(0), 200000).numpy()
    mean = float(np.sum(W * MU))
    var = float(np.sum(W * (SD ** 2 + MU ** 2)) - mean ** 2)
    assert abs(x.mean() - mean) < 4 * np.sqrt(var / x.size)
    assert abs(x.var() / var - 1.0) < 0.02


ERROR_CASES = [
    (ValueError, "group_ndims=0",
     lambda m, t: m.Mixture(t(np.zeros(3)), m.Normal(t(np.zeros(3)),
                                                     std=1.0,
                                                     group_ndims=1))),
    (ValueError, "component axis K",
     lambda m, t: m.Mixture(t(np.zeros(4)), m.Normal(t(np.zeros(3)),
                                                     std=1.0))),
    (ValueError, "batch axis",
     lambda m, t: m.Mixture(t(np.zeros(1)), m.Normal(t(0.0), std=1.0))),
    (TypeError, "Distribution",
     lambda m, t: m.Mixture(t(np.zeros(3)), t(np.zeros(3)))),
    (TypeError, "float array",
     lambda m, t: m.Mixture(t(np.zeros(3, np.int32)),
                            m.Normal(t(np.zeros(3)), std=1.0))),
    (ValueError, "at least one axis",
     lambda m, t: m.Mixture(t(0.0), m.Normal(t(np.zeros(3)), std=1.0))),
]


@pytest.mark.parametrize("case", ERROR_CASES,
                         ids=lambda c: "{}-{}".format(c[0].__name__, c[1]))
def test_checks_raise_as_in_jax(case):
    err, match, build = case
    with pytest.raises(err, match=match):
        build(jzd, jnp.asarray)
    with pytest.raises(err, match=match):
        build(tzd, torch.tensor)


@pytest.mark.parametrize("n_samples", [None, 8])
def test_mixture_sugar_node_matches_jax(n_samples):
    jbn = zs.BayesianNet(key=KEY)
    jnode = jbn.mixture("z", jnp.log(jnp.asarray(W)),
                        jzd.Normal(jnp.asarray(MU), std=jnp.asarray(SD)),
                        n_samples=n_samples)
    k = jax.random.fold_in(KEY, zlib.crc32(b"z"))
    key_comp, key_cat = jax.random.split(k)
    n = n_samples or 1
    comp_eps = np.asarray(jax.random.normal(key_comp, (n, 3), jnp.float64))
    u = np.asarray(jax.random.uniform(key_cat, (n, 3), jnp.float64,
                                      minval=TINY, maxval=1.0))
    if n_samples is None:
        comp_eps, u = comp_eps[0], u[0]
    tbn = BayesianNet(key=0, noise={"z": (torch.tensor(comp_eps),
                                          torch.tensor(u))})
    tnode = tbn.mixture("z", torch.log(torch.tensor(W)),
                        tzd.Normal(torch.tensor(MU), std=torch.tensor(SD)),
                        n_samples=n_samples)
    assert type(tnode.dist) is tzd.Mixture
    _close(tnode.tensor, jnode.tensor)
    _close(tbn.cond_log_prob("z"), jbn.cond_log_prob("z"))
    obs = BayesianNet(observed={"z": torch.tensor(1.3, dtype=torch.float64)})
    obs.mixture("z", torch.log(torch.tensor(W)),
                tzd.Normal(torch.tensor(MU), std=torch.tensor(SD)))
    want = np.log(np.sum(W * np.exp(-0.5 * ((1.3 - MU) / SD) ** 2)
                         / (SD * np.sqrt(2 * np.pi))))
    _close(obs.log_joint(), want)
