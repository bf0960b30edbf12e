"""Parity tests of zhusuan_tpu_torch's ``Bernoulli`` and its sugar method
``BayesianNet.bernoulli`` against the JAX package, on the CPU in float64.

A Bernoulli node's base draws are uniforms: the JAX package draws node
``name`` as ``uniform(fold_in(key, crc32(name)), (n_samples,) +
batch_shape)``; :func:`_node_u` rebuilds them and the port takes them
through ``Distribution.sample(eps=...)`` or ``BayesianNet(noise=...)``.
Log-probabilities and samples must agree to 1e-12, at logits up to +-30,
where ``torch.nn.functional.softplus`` (which returns ``x`` above 20) would
miss by up to ``exp(-20)``.
"""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu_torch import distributions as tdist
from zhusuan_tpu_torch.framework import BayesianNet

torch.set_num_threads(1)

TOL = 1e-12
KEY = jax.random.PRNGKey(7)
LOGITS = np.array([[-30.0, -25.0, -20.5, -3.2, -0.4, 0.0],
                   [0.7, 2.5, 19.5, 20.5, 25.0, 30.0]])


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _node_u(key, name, shape):
    """The uniforms the JAX package's Bernoulli node ``name`` draws."""
    k = jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))
    return np.asarray(jax.random.uniform(k, shape, jnp.float64))


@pytest.mark.parametrize("group_ndims", [0, 1])
@pytest.mark.parametrize("given_kind", ["int", "float", "soft"])
def test_log_prob_matches_jax(group_ndims, given_kind):
    rng = np.random.RandomState(0)
    if given_kind == "soft":
        given = rng.rand(3, *LOGITS.shape)
    else:
        given = (rng.rand(3, *LOGITS.shape) < 0.5).astype(
            np.int32 if given_kind == "int" else np.float64)
    jd = zs.distributions.Bernoulli(jnp.asarray(LOGITS),
                                    group_ndims=group_ndims)
    td = tdist.Bernoulli(torch.tensor(LOGITS), group_ndims=group_ndims)
    _close(td.log_prob(torch.tensor(given)), jd.log_prob(jnp.asarray(given)))
    _close(td.prob(torch.tensor(given)), jd.prob(jnp.asarray(given)))


@pytest.mark.parametrize("logit", [-30.0, -25.0, -20.5, 20.5, 25.0, 30.0])
def test_log_prob_keeps_the_softplus_tail(logit):
    """Both outcomes' log-probabilities against the closed form
    ``-max(-s l, 0) - log1p(exp(-|l|))`` (s = +-1 for x = 1 / 0) within a
    few float64 ulps of 30 (2e-14): a softplus that returns ``x`` above 20
    misses by ``log1p(exp(-|l|))``, 9.4e-14 at 30 and 1.3e-9 at 20.5."""
    td = tdist.Bernoulli(torch.tensor(logit, dtype=torch.float64))
    jd = zs.distributions.Bernoulli(jnp.float64(logit))
    tail = math.log1p(math.exp(-abs(logit)))
    for x, sign in ((1.0, 1.0), (0.0, -1.0)):
        want = -max(-sign * logit, 0.0) - tail
        got = td.log_prob(torch.tensor(x, dtype=torch.float64)).item()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-14)
        np.testing.assert_allclose(got, float(jd.log_prob(jnp.float64(x))),
                                   rtol=0, atol=2e-14)


def test_log_prob_gradient_matches_jax():
    rng = np.random.RandomState(1)
    given = (rng.rand(*LOGITS.shape) < 0.5).astype(np.float64)
    weights = rng.randn(*LOGITS.shape)

    def jax_f(logits):
        lp = zs.distributions.Bernoulli(logits).log_prob(given)
        return jnp.sum(weights * lp)

    logits = torch.tensor(LOGITS, requires_grad=True)
    lp = tdist.Bernoulli(logits).log_prob(torch.tensor(given))
    torch.sum(torch.tensor(weights) * lp).backward()
    _close(logits.grad, jax.grad(jax_f)(jnp.asarray(LOGITS)))


@pytest.mark.parametrize("n_samples", [None, 4])
def test_sample_from_the_jax_uniforms(n_samples):
    jd = zs.distributions.Bernoulli(jnp.asarray(LOGITS))
    want = jd.sample(KEY, n_samples=n_samples)
    u = np.asarray(jax.random.uniform(
        KEY, ((n_samples or 1),) + LOGITS.shape, jnp.float64))
    if n_samples is None:
        u = u[0]
    td = tdist.Bernoulli(torch.tensor(LOGITS))
    got = td.sample(n_samples=n_samples, eps=torch.tensor(u))
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    _close(got, want)


def test_defaults_and_checks():
    td = tdist.Bernoulli(torch.tensor(LOGITS))
    assert td.dtype == torch.int32 and td.param_dtype == torch.float64
    assert not td.is_reparameterized and not td.is_continuous
    assert td.batch_shape == LOGITS.shape and td.value_shape == ()
    assert tdist.Bernoulli(0.3).param_dtype == torch.float32
    with pytest.raises(ValueError, match="eps must have shape"):
        td.sample(n_samples=2, eps=torch.zeros(3, *LOGITS.shape))
    with pytest.raises(ValueError, match="Generator or eps"):
        td.sample()
    with pytest.raises(TypeError, match="float dtype"):
        tdist.Bernoulli(torch.tensor([1, 2]))


def test_sample_does_not_carry_gradient():
    logits = torch.tensor(LOGITS, requires_grad=True)
    s = tdist.Bernoulli(logits, dtype=torch.float64).sample(
        torch.Generator().manual_seed(0), n_samples=3)
    assert not s.requires_grad and s.shape == (3,) + LOGITS.shape
    assert set(torch.unique(s).tolist()) <= {0.0, 1.0}


@pytest.mark.parametrize("n_samples", [None, 3])
def test_sugar_node_matches_jax(n_samples):
    shape = ((n_samples or 1),) + LOGITS.shape
    jbn = zs.BayesianNet(key=KEY)
    jnode = jbn.bernoulli("x", jnp.asarray(LOGITS), group_ndims=1,
                          n_samples=n_samples)
    u = _node_u(KEY, "x", shape)
    if n_samples is None:
        u = u[0]
    tbn = BayesianNet(key=0, noise={"x": torch.tensor(u)})
    tnode = tbn.bernoulli("x", torch.tensor(LOGITS), group_ndims=1,
                          n_samples=n_samples)
    assert tnode.dtype == torch.int32
    _close(tnode.tensor, jnode.tensor)
    _close(tnode.cond_log_p, jnode.cond_log_p)
    # Observed, float dtype, as the VAE's likelihood node.
    obs = (np.asarray(jnode.tensor) > 0).astype(np.float32)
    jo = zs.BayesianNet(observed={"x": obs}).bernoulli(
        "x", jnp.asarray(LOGITS), group_ndims=1, dtype=jnp.float32)
    to = BayesianNet(observed={"x": torch.tensor(obs)}).bernoulli(
        "x", torch.tensor(LOGITS), group_ndims=1, dtype=torch.float32)
    _close(to.cond_log_p, jo.cond_log_p)


def test_sugar_node_draws_from_its_generator():
    def draw(key):
        bn = BayesianNet(key=key)
        return bn.bernoulli("h", torch.zeros(64, dtype=torch.float64),
                            n_samples=2).tensor

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
