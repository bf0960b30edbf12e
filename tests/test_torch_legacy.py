"""Tests of the port's deprecated legacy wrappers
(``zhusuan_tpu_torch/legacy/``), the cases of the JAX package's
``tests/framework/test_legacy.py``, and their parity with it.

What is held:

- every wrapper constructs inside ``with BayesianNet(key=...)``, warns
  ``FutureWarning``, registers under its name, picks up its observation
  (``BayesianNet._get_observation``) and samples the shape
  ``batch_shape + value_shape`` with a finite ``cond_log_p``; its sample is
  the one the net's own node of that name draws (the net's generator for
  the name);
- the ``key=`` path of a standalone wrapper: its generator is seeded by
  ``node_seed(key, name)``, the counterpart of ``fold_in(key,
  crc32(name))``; without a key or a net a wrapper raises, but
  ``Implicit`` and ``Empirical`` need none;
- the aliases, the flat re-export at the package's top level, and
  ``__all__`` equal to the JAX package's 28 names in its order;
- the log-joint of a legacy net equals the JAX package's on the same
  values (1e-12, float64).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu.legacy.framework import stochastic as jlegacy
from zhusuan_tpu_torch.framework import BayesianNet
from zhusuan_tpu_torch.framework.bn import node_seed
from zhusuan_tpu_torch.legacy.framework import stochastic as legacy

F = torch.float32


def _t(v):
    return torch.tensor(v, dtype=F)


def _eye(n):
    return torch.eye(n, dtype=F)


# name -> (args, kwargs, can_sample)
WRAPPER_CASES = {
    "Normal": ((), {"mean": _t(0.0), "std": _t(1.0)}, True),
    "FoldNormal": ((), {"mean": _t(0.0), "std": _t(1.0)}, True),
    "Bernoulli": ((_t(0.0),), {}, True),
    "Categorical": ((torch.zeros(3),), {}, True),
    "Uniform": ((), {"minval": _t(0.0), "maxval": _t(1.0)}, True),
    "Gamma": ((_t(1.0), _t(1.0)), {}, True),
    "Beta": ((_t(1.0), _t(1.0)), {}, True),
    "Poisson": ((_t(1.0),), {}, True),
    "Binomial": ((_t(0.0), 5), {}, True),
    "InverseGamma": ((_t(2.0), _t(1.0)), {}, True),
    "Laplace": ((_t(0.0), _t(1.0)), {}, True),
    "BinConcrete": ((_t(0.5), _t(0.0)), {}, True),
    "MultivariateNormalCholesky": ((torch.zeros(2), _eye(2)), {}, True),
    "MatrixVariateNormalCholesky": (
        (torch.zeros(2, 3), _eye(2), _eye(3)), {}, True),
    "Multinomial": ((torch.zeros(3), 4), {}, True),
    "UnnormalizedMultinomial": ((torch.zeros(3),), {}, False),
    "OnehotCategorical": ((torch.zeros(3),), {}, True),
    "Dirichlet": ((torch.ones(3),), {}, True),
    "ExpConcrete": ((_t(0.5), torch.zeros(3)), {}, True),
    "Concrete": ((_t(0.5), torch.zeros(3)), {}, True),
}


def _same(a, b):
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_wrapper_registers_and_samples(name):
    args, kwargs, can_sample = WRAPPER_CASES[name]
    cls = getattr(legacy, name)
    with pytest.warns(FutureWarning):
        with BayesianNet(key=7) as bn:
            node = cls("a", *args, **kwargs)
    assert bn.nodes["a"] is node and node.bn is bn
    assert node.name == "a"
    if can_sample:
        sample = node.tensor
        assert tuple(sample.shape) == (tuple(node.dist.batch_shape)
                                       + tuple(node.dist.value_shape))
        assert bool(torch.all(torch.isfinite(node.cond_log_p.double())))
        # The net's own node of the name draws the same.
        _same(sample, BayesianNet(key=7).stochastic("a", node.dist).tensor)
    else:
        with pytest.raises(NotImplementedError):
            _ = node.tensor


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_wrapper_standalone_with_key(name):
    args, kwargs, can_sample = WRAPPER_CASES[name]
    cls = getattr(legacy, name)
    with pytest.warns(FutureWarning):
        node = cls("a", *args, n_samples=2, key=11, **kwargs)
    assert node.bn is None
    if not can_sample:
        with pytest.raises(NotImplementedError):
            _ = node.tensor
        return
    assert node.tensor.shape[0] == 2
    gen = torch.Generator().manual_seed(node_seed(11, "a"))
    _same(node.tensor, node.dist.sample(gen, n_samples=2))


def test_aliases_are_identical():
    assert legacy.Discrete is legacy.Categorical
    assert legacy.OnehotDiscrete is legacy.OnehotCategorical
    assert legacy.BagofCategoricals is legacy.UnnormalizedMultinomial
    assert legacy.BinGumbelSoftmax is legacy.BinConcrete
    assert legacy.ExpGumbelSoftmax is legacy.ExpConcrete
    assert legacy.GumbelSoftmax is legacy.Concrete


def test_all_matches_jax_and_top_level_export():
    assert legacy.__all__ == jlegacy.__all__
    assert zt.legacy.__all__ == zs.legacy.__all__
    assert len(legacy.__all__) == 28
    for name in legacy.__all__:
        assert getattr(zt, name) is getattr(legacy, name), name
        assert name in zt.__all__
    assert zt.Normal is legacy.Normal
    assert zt.Implicit is legacy.Implicit
    assert zt.legacy.distributions.Empirical \
        is zt.distributions.special.Empirical
    assert zt.legacy.distributions.__all__ == ["Empirical", "Implicit"]


def test_bayesian_net_as_context_warns():
    with pytest.warns(FutureWarning, match="deprecated"):
        with BayesianNet() as bn:
            pass
    assert BayesianNet.try_get_context() is None
    assert bn.nodes == {}


def test_observation_pickup_and_log_joint_match_jax():
    x_obs = np.array([0.5, 1.0, 2.0])
    with pytest.warns(FutureWarning):
        with BayesianNet(observed={"x": torch.tensor(x_obs)}, key=3) as bn:
            mu = legacy.Normal("mu", mean=torch.tensor(0.0,
                                                       dtype=torch.float64),
                               std=torch.tensor(1.0, dtype=torch.float64))
            legacy.Normal("x", mean=mu, std=torch.tensor(
                1.0, dtype=torch.float64))
    assert bn["x"].is_observed and not bn["mu"].is_observed
    np.testing.assert_array_equal(bn["x"].tensor.numpy(), x_obs)
    mu_v = bn["mu"].tensor.numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with zs.BayesianNet(observed={"x": jnp.asarray(x_obs),
                                      "mu": jnp.asarray(mu_v)}) as jbn:
            jmu = jlegacy.Normal("mu", mean=jnp.float64(0.0),
                                 std=jnp.float64(1.0))
            jlegacy.Normal("x", mean=jmu, std=jnp.float64(1.0))
    np.testing.assert_allclose(bn.log_joint().numpy(),
                               np.asarray(jbn.log_joint()), rtol=1e-12,
                               atol=1e-12)


def test_duplicate_name_raises():
    with pytest.warns(FutureWarning):
        with BayesianNet(key=0):
            legacy.Normal("a", mean=_t(0.0), std=_t(1.0))
            with pytest.raises(ValueError, match="exists a node"):
                legacy.Normal("a", mean=_t(0.0), std=_t(1.0))


def test_standalone_without_key_raises():
    with pytest.warns(FutureWarning):
        node = legacy.Normal("a", mean=_t(0.0), std=_t(1.0))
    with pytest.raises(ValueError, match="no explicit key"):
        _ = node.tensor


def test_empirical_wrapper():
    with pytest.warns(FutureWarning):
        node = legacy.Empirical("e", np.float32, batch_shape=(2, 3))
    assert tuple(node.dist.batch_shape) == (2, 3)
    with pytest.raises(ValueError, match="can not sample"):
        _ = node.tensor
    # An observed Empirical node inside a net (the GAN data-node pattern).
    with pytest.warns(FutureWarning):
        with BayesianNet(observed={"e": torch.ones(2, 3)}) as bn:
            legacy.Empirical("e", np.float32, batch_shape=(2, 3))
    np.testing.assert_array_equal(bn["e"].tensor.numpy(), np.ones((2, 3)))


def test_implicit_wrapper_matches_jax():
    samples = np.arange(3.0, dtype=np.float32)
    with pytest.warns(FutureWarning):
        node = legacy.Implicit("i", torch.tensor(samples))
    with pytest.warns(FutureWarning):
        jnode = jlegacy.Implicit("i", jnp.asarray(samples))
    np.testing.assert_array_equal(node.tensor.numpy(),
                                  np.asarray(jnode.tensor))
    for given in (samples, samples + 1.0):
        np.testing.assert_array_equal(
            node.dist.prob(torch.tensor(given)).numpy(),
            np.asarray(jnode.dist.prob(jnp.asarray(given))))
    np.testing.assert_array_equal(
        node.dist.prob(torch.tensor(samples + 1.0)).numpy(),
        np.full(3, -np.inf))


def test_legacy_node_in_arithmetic():
    with pytest.warns(FutureWarning):
        node = legacy.Normal("a", mean=_t(0.0), std=_t(1.0), key=0)
    np.testing.assert_allclose((node + 1.0).numpy(),
                               node.tensor.numpy() + 1.0)


def test_jax_key_path_is_fold_in():
    """The JAX wrapper's ``key=`` draws from ``fold_in(key, crc32(name))``,
    the modern node's stream; the port's from ``node_seed(key, name)``,
    its modern node's. Each matches its own package's node."""
    key = jax.random.PRNGKey(4)
    with pytest.warns(FutureWarning):
        jnode = jlegacy.Normal("w", mean=jnp.zeros(3), std=jnp.ones(3),
                               key=key)
    want = zs.BayesianNet(key=key).normal("w", jnp.zeros(3),
                                          std=jnp.ones(3)).tensor
    np.testing.assert_array_equal(np.asarray(jnode.tensor),
                                  np.asarray(want))
    with pytest.warns(FutureWarning):
        tnode = legacy.Normal("w", mean=torch.zeros(3), std=torch.ones(3),
                              key=4)
    _same(tnode.tensor, BayesianNet(key=4).normal(
        "w", torch.zeros(3), std=torch.ones(3)).tensor)
