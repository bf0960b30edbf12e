"""Parity tests of the port's ``BayesianNet`` sugar methods
(``zhusuan_tpu_torch/framework/bn.py``) against the JAX package's, on the
CPU in float64.

Every sugar method of ``univariate.py`` and ``multivariate.py`` and its
alias builds its distribution with the JAX argument names: the node's
class, batch and value shapes, and its ``cond_log_prob`` at an observation
agree with the JAX package's node (1e-12; 1e-10 where ``lgamma`` enters).
An unobserved node draws the JAX package's sample when its base draws,
rebuilt from ``fold_in(key, crc32(name))``, go through ``noise=`` (1e-12;
indices and counts exactly); ``n_samples`` puts the sample axis in front.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu_torch import distributions as tzd
from zhusuan_tpu_torch.framework import BayesianNet

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(3)
TINY = float(np.finfo(np.float64).tiny)
RNG = np.random.RandomState(2)
L23 = RNG.randn(2, 3)
P23 = 0.5 + RNG.rand(2, 3)
U23 = 0.1 + 0.8 * RNG.rand(2, 3)
S23 = U23 / U23.sum(-1, keepdims=True)
TRIL = np.tril(RNG.randn(2, 2, 2) * 0.3, -1) + np.eye(2) * 1.3


def _normal(k, s):
    return jax.random.normal(k, s, jnp.float64)


def _uniform(k, s):
    return jax.random.uniform(k, s, jnp.float64)


def _open_uniform(k, s):
    return jax.random.uniform(k, s, jnp.float64, minval=TINY, maxval=1.0)


# (method, class, args, kwargs, observation, tol, base draws and their
# shape after (n_samples,), or None for a sampler fed by torch's own).
CASES = [
    ("normal", "Normal", (L23,), {"std": P23}, L23 + 0.1, 1e-12,
     (_normal, (2, 3))),
    ("fold_normal", "FoldNormal", (L23,), {"logstd": L23 * 0.1}, U23,
     1e-12, (_normal, (2, 3))),
    ("bernoulli", "Bernoulli", (L23,), {}, np.array([[0, 1, 1], [1, 0, 0]]),
     1e-12, (_uniform, (2, 3))),
    ("categorical", "Categorical", (L23,), {}, np.array([2, 0]), 1e-12,
     (_open_uniform, (2, 3))),
    ("discrete", "Categorical", (L23,), {}, np.array([1, 1]), 1e-12,
     (_open_uniform, (2, 3))),
    ("uniform", "Uniform", (L23, L23 + 1.0), {}, L23 + 0.5, 1e-12,
     (_uniform, (2, 3))),
    ("gamma", "Gamma", (P23, P23 + 1.0), {}, U23, 1e-10, None),
    ("beta", "Beta", (P23, P23 + 1.0), {}, U23, 1e-10, None),
    ("poisson", "Poisson", (P23,), {}, np.array([[0, 1, 4], [2, 0, 7]]),
     1e-10, None),
    ("binomial", "Binomial", (L23, 5), {},
     np.array([[0, 1, 4], [2, 5, 3]]), 1e-10, (_uniform, (5, 2, 3))),
    ("multivariate_normal_cholesky", "MultivariateNormalCholesky",
     (L23[:, :2], TRIL), {}, L23[:, 1:], 1e-12, (_normal, (2, 2))),
    ("multivariate_student_t_cholesky", "MultivariateStudentTCholesky",
     (np.array(4.0), L23[:, :2], TRIL), {}, L23[:, 1:], 1e-10, None),
    ("matrix_variate_normal_cholesky", "MatrixVariateNormalCholesky",
     (L23.reshape(1, 2, 3), TRIL[:1], np.eye(3) * 0.8), {},
     L23.reshape(1, 2, 3) * 2.0, 1e-12, (_normal, (1, 2, 3))),
    ("multinomial", "Multinomial", (L23, 4), {},
     np.array([[1, 0, 3], [2, 2, 0]]), 1e-10, (_open_uniform, (4, 2, 3))),
    ("unnormalized_multinomial", "UnnormalizedMultinomial", (L23,), {},
     np.array([[1, 0, 3], [2, 2, 0]]), 1e-12, None),
    ("bag_of_categoricals", "UnnormalizedMultinomial", (L23,),
     {"normalize_logits": False}, np.array([[1, 0, 3], [2, 2, 0]]), 1e-12,
     None),
    ("onehot_categorical", "OnehotCategorical", (L23,), {},
     np.array([[0, 0, 1], [1, 0, 0]]), 1e-12, (_open_uniform, (2, 3))),
    ("onehot_discrete", "OnehotCategorical", (L23,), {},
     np.array([[0, 1, 0], [1, 0, 0]]), 1e-12, (_open_uniform, (2, 3))),
    ("dirichlet", "Dirichlet", (P23,), {}, S23, 1e-10, None),
    ("inverse_gamma", "InverseGamma", (P23 + 1.0, P23), {}, U23 * 2.0,
     1e-10, None),
    ("laplace", "Laplace", (L23, P23), {}, L23 * 3.0, 1e-12,
     (_open_uniform, (2, 3))),
    ("bin_concrete", "BinConcrete", (np.array(0.6), L23), {}, U23, 1e-12,
     (_open_uniform, (2, 3))),
    ("bin_gumbel_softmax", "BinConcrete", (np.array(1.4), L23), {}, U23,
     1e-12, (_open_uniform, (2, 3))),
    ("exp_concrete", "ExpConcrete", (np.array(0.6), L23), {},
     np.log(S23), 1e-10, (_open_uniform, (2, 3))),
    ("exp_gumbel_softmax", "ExpConcrete", (np.array(0.9), L23), {},
     np.log(S23), 1e-10, (_open_uniform, (2, 3))),
    ("concrete", "Concrete", (np.array(0.6), L23), {}, S23, 1e-10,
     (_open_uniform, (2, 3))),
    ("gumbel_softmax", "Concrete", (np.array(2.0), L23), {}, S23, 1e-10,
     (_open_uniform, (2, 3))),
]
ALIASES = {"discrete": "categorical",
           "bag_of_categoricals": "unnormalized_multinomial",
           "onehot_discrete": "onehot_categorical",
           "bin_gumbel_softmax": "bin_concrete",
           "exp_gumbel_softmax": "exp_concrete",
           "gumbel_softmax": "concrete"}


def _conv(v, to):
    return to(v.copy()) if isinstance(v, np.ndarray) else v


def _obs(obs, to, int_dtype):
    if obs.dtype.kind == "i":
        return to(obs.copy(), dtype=int_dtype)
    return to(obs.copy())


def test_every_sugar_method_and_alias_is_ported():
    """The 21 methods and 6 aliases of the JAX package that build a
    ``univariate.py`` or ``multivariate.py`` distribution."""
    assert {c[0] for c in CASES} | set(ALIASES) == {c[0] for c in CASES}
    assert len(CASES) == 27
    for alias, target in ALIASES.items():
        assert getattr(BayesianNet, alias) is getattr(BayesianNet, target)
        assert getattr(zs.BayesianNet, alias) is getattr(zs.BayesianNet,
                                                         target)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_observed_node_matches_jax(case):
    method, cls, args, kwargs, obs, tol, _ = case
    jbn = zs.BayesianNet(observed={"v": _obs(obs, jnp.asarray, jnp.int32)})
    jnode = getattr(jbn, method)("v", *[_conv(a, jnp.asarray) for a in args],
                                 **kwargs)
    tbn = BayesianNet(observed={"v": _obs(obs, torch.tensor, torch.int32)})
    tnode = getattr(tbn, method)("v", *[_conv(a, torch.tensor)
                                        for a in args], **kwargs)
    assert type(tnode.dist) is getattr(tzd, cls)
    assert type(jnode.dist).__name__ == cls
    assert tuple(tnode.dist.batch_shape) == tuple(jnode.dist.batch_shape)
    assert tuple(tnode.dist.value_shape) == tuple(jnode.dist.value_shape)
    np.testing.assert_allclose(
        tbn.cond_log_prob("v").numpy(), np.asarray(jbn.cond_log_prob("v")),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("n_samples", [None, 3])
@pytest.mark.parametrize("case", [c for c in CASES if c[6] is not None],
                         ids=lambda c: c[0])
def test_sampled_node_from_jax_draws_matches_jax(case, n_samples):
    method, _, args, kwargs, _, _, (base, shape) = case
    name = "v"
    jbn = zs.BayesianNet(key=KEY)
    jnode = getattr(jbn, method)(name, *[_conv(a, jnp.asarray)
                                         for a in args],
                                 n_samples=n_samples, **kwargs)
    k = jax.random.fold_in(KEY, zlib.crc32(name.encode()))
    eps = np.asarray(base(k, (n_samples or 1,) + shape))
    if n_samples is None:
        eps = eps[0]
    tbn = BayesianNet(key=0, noise={name: torch.tensor(eps)})
    tnode = getattr(tbn, method)(name, *[_conv(a, torch.tensor)
                                         for a in args],
                                 n_samples=n_samples, **kwargs)
    want = np.asarray(jnode.tensor)
    got = tnode.tensor.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tbn.cond_log_prob(name).numpy(), np.asarray(jbn.cond_log_prob(name)),
        rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] is None
                                  and "unnormalized" not in c[1].lower()],
                         ids=lambda c: c[0])
def test_torch_sampled_node_shapes_and_reproducibility(case):
    """Nodes drawn by torch's own samplers: shapes with and without
    ``n_samples``, one key reproduces, finite log-probabilities."""
    method, _, args, kwargs, _, _, _ = case
    targs = [_conv(a, torch.tensor) for a in args]
    draws = []
    for _ in range(2):
        bn = BayesianNet(key=11)
        node = getattr(bn, method)("v", *targs, n_samples=4, **kwargs)
        draws.append(node.tensor)
        assert tuple(node.tensor.shape) == (4,) + tuple(
            node.dist.batch_shape) + tuple(node.dist.value_shape)
        assert bool(torch.isfinite(bn.cond_log_prob("v")).all())
    assert torch.equal(draws[0], draws[1])
    single = getattr(BayesianNet(key=11), method)("v", *targs, **kwargs)
    assert tuple(single.tensor.shape) == tuple(
        single.dist.batch_shape) + tuple(single.dist.value_shape)


def test_unnormalized_multinomial_node_drops_n_samples():
    """As in the JAX package, the node passes no ``n_samples`` on (the
    distribution cannot be sampled) and sampling it raises."""
    bn = BayesianNet(key=0)
    node = bn.unnormalized_multinomial("v", torch.zeros(3), n_samples=2)
    jnode = zs.BayesianNet(key=KEY).unnormalized_multinomial(
        "v", jnp.zeros(3), n_samples=2)
    assert node.n_samples is None and jnode.n_samples is None
    node = bn.bag_of_categoricals("w", torch.zeros(3))
    with pytest.raises(NotImplementedError):
        _ = node.tensor


def test_integer_observation_of_a_float_node_raises():
    bn = BayesianNet(observed={"v": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(ValueError, match="dtype"):
        bn.laplace("v", torch.zeros(3), torch.ones(3))
