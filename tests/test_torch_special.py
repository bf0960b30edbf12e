"""Parity tests of the port's ``Empirical`` and ``Implicit``
(``zhusuan_tpu_torch/distributions/special.py``) and the ``BayesianNet``
sugar methods ``implicit`` and ``empirical`` against the JAX package's, on
the CPU.

What is held, and to what:

- ``Implicit``: ``prob`` and ``log_prob`` on the same inputs exactly (1/0
  for an integer dtype, ``+inf`` / ``-inf`` for a float one, as the
  reference's ``(2 equal - 1) inf``), batch and value shapes with and
  without ``value_shape``, ``group_ndims``, and ``sample`` (the wrapped
  tensor, tiled);
- ``Empirical``: the declared shapes and dtype (a numpy dtype, its name or
  a torch dtype; ``value_shape=None`` is scalar), ``is_continuous``, and
  ``sample`` / ``log_prob`` / ``prob`` raising with the JAX package's
  messages (``tests/distributions/test_error_paths.py``);
- the two sugar methods build the same nodes as the JAX package's, an
  observed ``empirical`` node reads its observation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu import distributions as jzd
from zhusuan_tpu_torch import distributions as tzd
from zhusuan_tpu_torch.framework import BayesianNet

KEY = jax.random.PRNGKey(3)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.mark.parametrize("samples,value_shape,given", [
    (np.array([1.0, 2.0, 3.0]), (), np.array([1.0, 0.0, 3.0])),
    (np.arange(6.0).reshape(2, 3), (3,), np.array([[0.0, 1.0, 2.0],
                                                   [3.0, 0.0, 5.0]])),
    (np.array([1, 2, 3], np.int32), (), np.array([1, 2, 0], np.int32)),
    (np.arange(4, dtype=np.int64).reshape(2, 2), None,
     np.array([[0, 1], [9, 3]], np.int64)),
])
def test_implicit_matches_jax(samples, value_shape, given):
    jd = jzd.Implicit(jnp.asarray(samples), value_shape=value_shape)
    td = tzd.Implicit(torch.tensor(samples), value_shape=value_shape)
    assert td.batch_shape == tuple(jd.batch_shape)
    assert td.value_shape == tuple(jd.value_shape)
    assert td.is_continuous == jd.is_continuous
    np.testing.assert_array_equal(_np(td.prob(torch.tensor(given))),
                                  np.asarray(jd.prob(jnp.asarray(given))))
    np.testing.assert_array_equal(
        _np(td.log_prob(torch.tensor(given))),
        np.asarray(jd.log_prob(jnp.asarray(given))))
    np.testing.assert_array_equal(_np(td.sample(None, 3)),
                                  np.asarray(jd.sample(KEY, 3)))
    np.testing.assert_array_equal(_np(td.sample(None)), samples)


def test_implicit_group_ndims():
    s = np.arange(6.0).reshape(2, 3)
    jd = jzd.Implicit(jnp.asarray(s), group_ndims=1)
    td = tzd.Implicit(torch.tensor(s), group_ndims=1)
    g = s.copy()
    g[1, 2] = -1.0
    np.testing.assert_array_equal(_np(td.prob(torch.tensor(g))),
                                  np.asarray(jd.prob(jnp.asarray(g))))
    np.testing.assert_array_equal(_np(td.log_prob(torch.tensor(g))),
                                  np.asarray(jd.log_prob(jnp.asarray(g))))


@pytest.mark.parametrize("dtype,tdtype", [
    (np.float32, torch.float32), ("float64", torch.float64),
    (np.int32, torch.int32), (torch.float64, torch.float64)])
def test_empirical_shapes_and_dtype(dtype, tdtype):
    jdtype = np.float64 if dtype is torch.float64 else dtype
    jd = jzd.Empirical(jdtype, batch_shape=(2, 3), value_shape=None)
    td = tzd.Empirical(dtype, batch_shape=(2, 3), value_shape=None)
    assert td.dtype == tdtype
    assert td.batch_shape == tuple(jd.batch_shape) == (2, 3)
    assert td.value_shape == tuple(jd.value_shape) == ()
    assert td.is_continuous == jd.is_continuous


def test_empirical_raises_as_jax():
    td = tzd.Empirical(torch.float32, batch_shape=(2,), value_shape=())
    with pytest.raises(ValueError, match="can not sample"):
        td.sample(torch.Generator())
    with pytest.raises(ValueError, match="log-probability"):
        td.log_prob(torch.zeros(2))
    with pytest.raises(ValueError, match="probability density"):
        td.prob(torch.zeros(2))
    assert not tzd.Empirical(np.int32, is_continuous=False).is_continuous


def test_sugar_methods_match_jax():
    data = np.ones((2, 3), np.float32)
    samples = np.arange(3.0, dtype=np.float32)
    jbn = zs.BayesianNet(observed={"e": jnp.asarray(data)}, key=KEY)
    je = jbn.empirical("e", np.float32, batch_shape=(2, 3))
    ji = jbn.implicit("i", jnp.asarray(samples))
    tbn = BayesianNet(observed={"e": torch.tensor(data)}, key=0)
    te = tbn.empirical("e", np.float32, batch_shape=(2, 3))
    ti = tbn.implicit("i", torch.tensor(samples))
    assert type(te.dist).__name__ == type(je.dist).__name__ == "Empirical"
    assert type(ti.dist).__name__ == type(ji.dist).__name__ == "Implicit"
    assert te.is_observed and je.is_observed and not ti.is_observed
    np.testing.assert_array_equal(_np(te.tensor), np.asarray(je.tensor))
    np.testing.assert_array_equal(_np(ti.tensor), np.asarray(ji.tensor))
    np.testing.assert_array_equal(_np(ti.cond_log_p),
                                  np.asarray(ji.cond_log_p))
    assert tbn._get_observation("e") is tbn.observed["e"]
    assert tbn._get_observation("i") is None
