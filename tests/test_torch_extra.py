"""Parity tests of the port's heads beyond the reference zoo
(``zhusuan_tpu_torch/distributions/extra.py``) and their ``BayesianNet``
sugar methods against the JAX package's, on the CPU in float64.

What is held, and to what:

- ``log_prob`` of all thirteen classes on the same numpy inputs, with
  batch shapes, ``group_ndims``, out-of-support values and leading sample
  axes, and ``log_survival`` where a class has one (``Exponential``,
  ``LogNormal``, ``Weibull``): 1e-12, or 1e-10 where ``lgamma`` or
  ``i0e`` enters; the gradient of ``log_prob`` with respect to every float
  parameter to the same tolerance;
- samples of every class whose base draws can be fed in (``Exponential``,
  ``Cauchy``, ``HalfCauchy``, ``LogNormal``, ``TruncatedNormal``,
  ``Weibull``, ``OrderedLogistic``, ``RightCensored`` over a ``Weibull``):
  the JAX package's own draws go through ``eps=`` and the samples agree to
  1e-12 (counts exactly);
- samples of the rest (``StudentT``, ``NegativeBinomial``,
  ``BetaBinomial``, ``ZeroInflated``, ``VonMises``) from torch's samplers:
  mean and variance within 4 standard errors of the exact values;
- the JAX tests' checks (``tests/distributions/{test_extra,test_survival,
  test_ordinal_zeroinflated}.py``), with their messages;
- the 12 sugar methods of ``extra.py``: the same node as the JAX package's,
  and the same sample when the JAX node's base draws, rebuilt from
  ``fold_in(key, crc32(name))``, go through ``noise=``.
"""

import math
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

KEY = jax.random.PRNGKey(5)
TINY = float(np.finfo(np.float64).tiny)
RNG = np.random.RandomState(7)
L23 = RNG.randn(2, 3)
P23 = 0.5 + RNG.rand(2, 3) * 2.0
U23 = 0.1 + 0.8 * RNG.rand(2, 3)
CUTS = np.array([-1.0, 0.3, 1.5])
COUNTS = np.array([[0, 1, 4], [2, 0, 7]])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _conv(v, to):
    return to(v.copy()) if isinstance(v, np.ndarray) else v


def _make(module, name, args, kwargs, to):
    """``module.name`` on the arguments converted by ``to``; a nested
    ``(class name, args)`` tuple is a base distribution built likewise."""
    def conv(v):
        if isinstance(v, tuple) and v and isinstance(v[0], str):
            return _make(module, v[0], v[1], {}, to)
        return _conv(v, to)

    return getattr(module, name)(*[conv(a) for a in args],
                                 **{k: conv(v) for k, v in kwargs.items()})


def _pair(name, args, kwargs=None):
    kwargs = kwargs or {}
    return (_make(jzd, name, args, kwargs, jnp.asarray),
            _make(tzd, name, args, kwargs, torch.tensor))


def _given(x, to, int_dtype):
    if x.dtype.kind == "i":
        return to(x.copy(), dtype=int_dtype)
    return to(x.copy())


# (class, args, kwargs, values to score, tolerance): out-of-support points
# and a leading sample axis among the values.
LOG_PROB_CASES = [
    ("StudentT", (P23 + 1.0, L23, P23), {},
     np.stack([L23 * 2.0, L23 - 3.0]), 1e-10),
    ("Exponential", (P23,), {}, np.stack([U23 * 3.0, -U23]), 1e-12),
    ("Cauchy", (L23, P23), {}, np.stack([L23 * 4.0, L23]), 1e-12),
    ("HalfCauchy", (P23,), {}, np.stack([U23 * 5.0, -U23]), 1e-12),
    ("LogNormal", (L23, P23), {}, np.stack([U23 * 2.0, -U23]), 1e-12),
    ("NegativeBinomial", (L23, P23 + 1.0), {}, COUNTS, 1e-10),
    ("TruncatedNormal", (L23, P23, L23 - 1.0, L23 + 2.0), {},
     np.stack([L23 + 0.5, L23 - 1.5, L23 + 2.5]), 1e-12),
    ("TruncatedNormal", (np.zeros(3), np.ones(3), np.full(3, 6.0),
                         np.full(3, 9.0)), {},
     np.array([6.5, 8.0, 7.0]), 1e-10),
    ("OrderedLogistic", (L23, np.broadcast_to(CUTS, (2, 3, 3))), {},
     np.array([[0, 1, 3], [2, 3, 0]]), 1e-12),
    ("ZeroInflated", (("Poisson", (P23,)), L23), {},
     np.stack([COUNTS, COUNTS * 0]), 1e-10),
    ("ZeroInflated", (("NegativeBinomial", (L23, P23)), L23[0]), {},
     COUNTS, 1e-10),
    ("Weibull", (P23, P23 + 0.5), {}, np.stack([U23 * 3.0, -U23]), 1e-12),
    ("RightCensored", (("Weibull", (P23, P23 + 0.5)), U23 * 2.0), {},
     np.stack([U23, U23 * 2.0, U23 * 3.0]), 1e-12),
    ("RightCensored", (("LogNormal", (L23, P23)), U23 * 2.0), {},
     np.stack([U23, U23 * 2.0]), 1e-12),
    ("BetaBinomial", (6, P23, P23 + 1.0), {},
     np.array([[0, 1, 4], [2, 6, 3]]), 1e-10),
    ("VonMises", (L23, P23 * 3.0), {}, np.stack([L23 * 2.0, -L23]), 1e-10),
]


@pytest.mark.parametrize("group_ndims", [0, 1])
@pytest.mark.parametrize("case", LOG_PROB_CASES,
                         ids=lambda c: "{}-{}".format(c[0], c[3].shape))
def test_log_prob_matches_jax(case, group_ndims):
    name, args, kwargs, values, tol = case
    jd, td = _pair(name, args, dict(kwargs, group_ndims=group_ndims))
    assert tuple(td.batch_shape) == tuple(jd.batch_shape)
    assert tuple(td.value_shape) == tuple(jd.value_shape)
    assert td.is_continuous == jd.is_continuous
    assert td.is_reparameterized == jd.is_reparameterized
    want = jd.log_prob(_given(values, jnp.asarray, jnp.int32))
    got = td.log_prob(_given(values, torch.tensor, torch.int32))
    assert got.dtype == torch.float64
    _close(got, want, tol)


@pytest.mark.parametrize("case", [c for c in LOG_PROB_CASES
                                  if c[3].dtype.kind == "f"],
                         ids=lambda c: "{}-{}".format(c[0], c[3].shape))
def test_log_prob_gradients_match_jax(case):
    """d sum(log_prob) / d parameter, for every float array parameter."""
    name, args, kwargs, values, tol = case
    idx = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    finite = np.isfinite(_np(_pair(name, args, kwargs)[1].log_prob(
        torch.tensor(values))))

    def jax_lp(*params):
        full = list(args)
        for i, p in zip(idx, params):
            full[i] = p
        d = _make(jzd, name, full, kwargs, jnp.asarray)
        return jnp.sum(jnp.where(finite, d.log_prob(jnp.asarray(values)),
                                 0.0))

    want = jax.grad(jax_lp, argnums=tuple(range(len(idx))))(
        *[jnp.asarray(args[i]) for i in idx])
    params = [torch.tensor(args[i].copy(), requires_grad=True) for i in idx]
    full = list(args)
    for i, p in zip(idx, params):
        full[i] = p
    td = _make(tzd, name, full, kwargs, lambda v: v)
    lp = td.log_prob(torch.tensor(values))
    torch.where(torch.tensor(finite), lp, torch.zeros_like(lp)).sum() \
        .backward()
    for p, w in zip(params, want):
        _close(p.grad, w, tol)


@pytest.mark.parametrize("name,args", [
    ("Exponential", (P23,)),
    ("LogNormal", (L23, P23)),
    ("Weibull", (P23, P23 + 0.5)),
])
def test_log_survival_matches_jax(name, args):
    jd, td = _pair(name, args)
    x = np.stack([U23 * 2.0, -U23, U23 * 30.0])
    _close(td.log_survival(torch.tensor(x)),
           jd.log_survival(jnp.asarray(x)), 1e-12)


def test_unimplemented_log_survival_raises():
    with pytest.raises(NotImplementedError, match="log_survival"):
        tzd.Cauchy(torch.tensor(0.0), torch.tensor(1.0)).log_survival(
            torch.tensor(1.0))


def _open_uniform(k, s):
    return jax.random.uniform(k, s, jnp.float64, minval=TINY, maxval=1.0)


def _uniform(k, s):
    return jax.random.uniform(k, s, jnp.float64)


def _normal(k, s):
    return jax.random.normal(k, s, jnp.float64)


# (class, args, base draws of shape (n,) + this); the JAX sampler draws them
# from its key in the same call.
EPS_CASES = [
    ("Exponential", (P23,), _open_uniform, (2, 3)),
    ("Cauchy", (L23, P23), _open_uniform, (2, 3)),
    ("HalfCauchy", (P23,), _open_uniform, (2, 3)),
    ("LogNormal", (L23, P23), _normal, (2, 3)),
    ("TruncatedNormal", (L23, P23, L23 - 1.0, L23 + 0.5), _uniform, (2, 3)),
    ("Weibull", (P23, P23 + 0.5), _open_uniform, (2, 3)),
    ("OrderedLogistic", (L23, CUTS), _open_uniform, (2, 3)),
    ("RightCensored", (("Weibull", (P23, P23 + 0.5)), U23 * 2.0),
     _open_uniform, (2, 3)),
    ("RightCensored", (("Weibull", (P23[0], P23[0] + 0.5)), U23 * 2.0),
     _open_uniform, (2, 3)),
]


@pytest.mark.parametrize("n_samples", [None, 4])
@pytest.mark.parametrize("case", EPS_CASES, ids=lambda c: c[0])
def test_sample_from_jax_draws_matches_jax(case, n_samples):
    name, args, base, shape = case
    jd, td = _pair(name, args)
    want = np.asarray(jd.sample(KEY, n_samples=n_samples))
    eps = np.asarray(base(KEY, (n_samples or 1,) + shape))
    if n_samples is None:
        eps = eps[0]
    got = td.sample(n_samples=n_samples, eps=torch.tensor(eps))
    assert tuple(got.shape) == want.shape
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(_np(got), want)
    else:
        _close(got, want, 1e-12)


def _moments_ok(x, mean, var, ses=4.0):
    x = _np(x).astype(np.float64)
    n = x.shape[0]
    m, v = x.mean(0), x.var(0)
    fourth = np.mean((x - mean) ** 4, axis=0)
    assert np.all(np.abs(m - mean) <= ses * np.sqrt(var / n)), (m, mean)
    assert np.all(np.abs(v - var) <= ses * np.sqrt((fourth - var ** 2) / n)
                  + 1e-12), (v, var)


def test_torch_sampler_moments():
    """The classes that draw from torch's samplers: mean and variance at a
    fixed seed against their exact values."""
    n = 200000
    g = torch.Generator().manual_seed(3)
    df, loc, scale = 7.0, 0.5, 1.5
    _moments_ok(tzd.StudentT(torch.tensor(df, dtype=torch.float64), loc,
                             scale).sample(g, n),
                loc, scale ** 2 * df / (df - 2.0), ses=5.0)
    logits, r = 0.3, 4.0
    p = 1.0 / (1.0 + math.exp(-logits))
    _moments_ok(tzd.NegativeBinomial(
        torch.tensor(logits, dtype=torch.float64), r).sample(g, n),
        r * p / (1 - p), r * p / (1 - p) ** 2)
    nn, a, b = 8, 2.0, 3.0
    _moments_ok(tzd.BetaBinomial(nn, torch.tensor(a, dtype=torch.float64),
                                 b).sample(g, n),
                nn * a / (a + b),
                nn * a * b * (a + b + nn) / ((a + b) ** 2 * (a + b + 1)))
    rate, pi_l = 2.5, -0.4
    pi = 1.0 / (1.0 + math.exp(-pi_l))
    _moments_ok(tzd.ZeroInflated(
        tzd.Poisson(torch.tensor(rate, dtype=torch.float64)),
        pi_l).sample(g, n),
        (1 - pi) * rate, (1 - pi) * rate * (1 + pi * rate))
    for kappa in (0.3, 2.0, 20.0):
        x = tzd.VonMises(torch.tensor(0.4, dtype=torch.float64),
                         kappa).sample(g, n)
        assert bool(((x > -math.pi) & (x <= math.pi)).all())
        # E[cos(x - loc)] = I1(kappa) / I0(kappa), E[sin(x - loc)] = 0.
        r1 = float(torch.special.i1e(torch.tensor(kappa))
                   / torch.special.i0e(torch.tensor(kappa)))
        c = torch.cos(x - 0.4)
        r2 = 0.5 * (1.0 + float(
            torch.special.modified_bessel_i0(torch.tensor(kappa)) ** -1
            * _i2(kappa)))
        _moments_ok(c, r1, r2 - r1 ** 2)
        _moments_ok(torch.sin(x - 0.4), 0.0, 1.0 - r2)


def _i2(kappa):
    """I_2(kappa) by the recurrence I2 = I0 - 2 I1 / kappa."""
    k = torch.tensor(kappa, dtype=torch.float64)
    i0 = torch.special.modified_bessel_i0(k)
    i1 = torch.special.modified_bessel_i1(k)
    return float(i0 - 2.0 * i1 / k)


def test_student_t_reparameterized_df_carries_a_gradient():
    df = torch.tensor(5.0, dtype=torch.float64, requires_grad=True)
    g = torch.Generator().manual_seed(0)
    tzd.StudentT(df, 0.0, 1.0, reparameterize_df=True).sample(
        g, 64).abs().sum().backward()
    assert df.grad is not None and bool(torch.isfinite(df.grad))
    df2 = torch.tensor(5.0, dtype=torch.float64, requires_grad=True)
    x = tzd.StudentT(df2, 0.0, 1.0).sample(g, 8)
    assert not x.requires_grad or x.grad_fn is None or df2.grad is None


def test_reparameterized_samples_carry_gradients():
    loc = torch.tensor(L23.copy(), requires_grad=True)
    scale = torch.tensor(P23.copy(), requires_grad=True)
    u = torch.tensor(np.asarray(_open_uniform(KEY, (3, 2, 3))))
    tzd.Cauchy(loc, scale).sample(n_samples=3, eps=u).sum().backward()
    _close(loc.grad, np.full((2, 3), 3.0), 1e-12)
    _close(scale.grad, np.tan(np.pi * (_np(u) - 0.5)).sum(0), 1e-12)
    off = tzd.Exponential(scale, is_reparameterized=False).sample(
        n_samples=2, eps=u[:2])
    assert not off.requires_grad


def test_eps_checks():
    with pytest.raises(ValueError, match="takes no eps"):
        tzd.StudentT(4.0).sample(n_samples=2, eps=torch.zeros(2))
    with pytest.raises(ValueError, match="takes no eps"):
        tzd.VonMises(0.0, 1.0).sample(n_samples=2, eps=torch.zeros(2))
    with pytest.raises(ValueError, match="eps must have shape"):
        tzd.Weibull(torch.ones(3), 1.0).sample(n_samples=2,
                                               eps=torch.rand(3, 3))


ERROR_CASES = [
    (TypeError, "same dtype",
     lambda m, t: m.StudentT(t(4.0, "float32"), t(0.0), t(1.0))),
    (ValueError, "trailing",
     lambda m, t: m.OrderedLogistic(t(0.0), t(1.0))),
    (ValueError, "DISCRETE",
     lambda m, t: m.ZeroInflated(m.Normal(t(0.0), std=t(1.0)), 0.0)),
    (ValueError, "group_ndims",
     lambda m, t: m.ZeroInflated(m.Poisson(t(np.zeros(3)), group_ndims=1),
                                 0.0)),
    (TypeError, "Distribution", lambda m, t: m.ZeroInflated(object(), 0.0)),
    (ValueError, "scalar event",
     lambda m, t: m.ZeroInflated(m.Multinomial(t(np.zeros(3)), 2), 0.0)),
    (TypeError, "Distribution", lambda m, t: m.RightCensored(object(), 1.0)),
    (ValueError, "group_ndims",
     lambda m, t: m.RightCensored(m.Exponential(t(np.ones(3)),
                                                group_ndims=1), 1.0)),
    (ValueError, "size-1 batch axis",
     lambda m, t: m.RightCensored(m.Weibull(t(np.ones((1, 3))),
                                            t(np.ones((1, 3)))),
                                  t(np.ones((5, 3))))),
    (ValueError, "size-1 batch axis",
     lambda m, t: m.ZeroInflated(m.Poisson(t(np.ones((1, 3)))),
                                 t(np.ones((5, 3))))),
    (ValueError, "positive int",
     lambda m, t: m.BetaBinomial(0, 1.0, 1.0)),
    (ValueError, "positive int",
     lambda m, t: m.BetaBinomial(True, 1.0, 1.0)),
    (ValueError, "positive int",
     lambda m, t: m.BetaBinomial(2.0, 1.0, 1.0)),
    (ValueError, "broadcast|Shapes",
     lambda m, t: m.Cauchy(t(np.zeros(3)), t(np.ones(4)))),
]


@pytest.mark.parametrize("case", ERROR_CASES,
                         ids=lambda c: "{}-{}".format(c[0].__name__, c[1]))
def test_checks_raise_as_in_jax(case):
    err, match, build = case

    def jt(v, dtype="float64"):
        return jnp.asarray(v, dtype)

    def tt(v, dtype="float64"):
        return torch.tensor(v, dtype=getattr(torch, dtype))

    with pytest.raises(err, match=match):
        build(jzd, jt)
    with pytest.raises(err, match=match):
        build(tzd, tt)


def test_unordered_cutpoints_give_nan():
    for m, t in ((jzd, jnp.asarray), (tzd, torch.tensor)):
        d = m.OrderedLogistic(t(np.array([0.0])),
                              t(np.array([[1.0, 0.5, 2.0]])))
        lp = _np(d.log_prob(t(np.array([1]))))
        assert np.isnan(lp).all()


def test_extended_batch_draws_are_independent():
    """A wrapper's parameter that adds leading batch axes gets one base
    draw per element, never a broadcast copy (JAX
    ``test_survival.py:187-209``)."""
    g = torch.Generator().manual_seed(1)
    base = tzd.Weibull(torch.ones(3, dtype=torch.float64), 1.5)
    x = tzd.RightCensored(base, torch.full((4, 3), 50.0,
                                           dtype=torch.float64)).sample(g, 2)
    assert tuple(x.shape) == (2, 4, 3)
    assert len(torch.unique(x)) == x.numel()
    z = tzd.ZeroInflated(tzd.Poisson(torch.full((3,), 40.0,
                                                dtype=torch.float64)),
                         torch.full((5, 3), -20.0, dtype=torch.float64))
    draws = z.sample(g, 4)
    assert tuple(draws.shape) == (4, 5, 3)
    assert not bool((draws == draws[:, :1]).all())


# -- the BayesianNet sugar methods of extra.py ------------------------- #
# (method, class, args, kwargs, observation, tol, base draws and their
# shape after (n_samples,), or None for a sampler fed by torch's own).
SUGAR_CASES = [
    ("student_t", "StudentT", (P23 + 2.0, L23, P23), {}, L23 * 2.0, 1e-10,
     None),
    ("exponential", "Exponential", (P23,), {}, U23, 1e-12,
     (_open_uniform, (2, 3))),
    ("cauchy", "Cauchy", (L23, P23), {}, L23 * 3.0, 1e-12,
     (_open_uniform, (2, 3))),
    ("half_cauchy", "HalfCauchy", (P23,), {}, U23, 1e-12,
     (_open_uniform, (2, 3))),
    ("log_normal", "LogNormal", (L23, P23), {}, U23, 1e-12,
     (_normal, (2, 3))),
    ("negative_binomial", "NegativeBinomial", (L23, P23), {}, COUNTS, 1e-10,
     None),
    ("truncated_normal", "TruncatedNormal", (L23, P23, L23 - 1.0, L23 + 1.0),
     {}, L23 + 0.3, 1e-12, (_uniform, (2, 3))),
    ("weibull", "Weibull", (P23, P23 + 0.5), {}, U23, 1e-12,
     (_open_uniform, (2, 3))),
    ("right_censored", "RightCensored", (("Weibull", (P23, P23 + 0.5)),
                                          U23 * 2.0), {}, U23 * 1.5, 1e-12,
     (_open_uniform, (2, 3))),
    ("beta_binomial", "BetaBinomial", (5, P23, P23 + 1.0), {},
     np.array([[0, 1, 4], [2, 5, 3]]), 1e-10, None),
    ("ordered_logistic", "OrderedLogistic", (L23, CUTS), {},
     np.array([[0, 1, 3], [2, 3, 0]]), 1e-12, (_open_uniform, (2, 3))),
    ("zero_inflated", "ZeroInflated", (("Poisson", (P23,)), L23), {},
     COUNTS, 1e-10, None),
]


def _sugar_args(args, module, to):
    return [_make(module, a[0], a[1], {}, to)
            if isinstance(a, tuple) else _conv(a, to) for a in args]


def test_every_extra_sugar_method_is_ported():
    names = {c[0] for c in SUGAR_CASES} | {"mixture"}
    assert len(names) == 13
    for name in names:
        assert callable(getattr(BayesianNet, name))
        assert callable(getattr(zs.BayesianNet, name))


@pytest.mark.parametrize("case", SUGAR_CASES, ids=lambda c: c[0])
def test_observed_sugar_node_matches_jax(case):
    method, cls, args, kwargs, obs, tol, _ = case
    jbn = zs.BayesianNet(observed={"v": _given(obs, jnp.asarray, jnp.int32)})
    jnode = getattr(jbn, method)("v", *_sugar_args(args, jzd, jnp.asarray),
                                 group_ndims=1, **kwargs)
    tbn = BayesianNet(observed={"v": _given(obs, torch.tensor, torch.int32)})
    tnode = getattr(tbn, method)("v", *_sugar_args(args, tzd, torch.tensor),
                                 group_ndims=1, **kwargs)
    assert type(tnode.dist) is getattr(tzd, cls)
    assert type(jnode.dist).__name__ == cls
    assert tuple(tnode.dist.batch_shape) == tuple(jnode.dist.batch_shape)
    _close(tbn.cond_log_prob("v"), jbn.cond_log_prob("v"), tol)


@pytest.mark.parametrize("n_samples", [None, 3])
@pytest.mark.parametrize("case", [c for c in SUGAR_CASES
                                  if c[6] is not None], ids=lambda c: c[0])
def test_sampled_sugar_node_from_jax_draws_matches_jax(case, n_samples):
    method, _, args, kwargs, _, _, (base, shape) = case
    jbn = zs.BayesianNet(key=KEY)
    jnode = getattr(jbn, method)("v", *_sugar_args(args, jzd, jnp.asarray),
                                 n_samples=n_samples, **kwargs)
    k = jax.random.fold_in(KEY, zlib.crc32(b"v"))
    eps = np.asarray(base(k, (n_samples or 1,) + shape))
    if n_samples is None:
        eps = eps[0]
    tbn = BayesianNet(key=0, noise={"v": torch.tensor(eps)})
    tnode = getattr(tbn, method)("v", *_sugar_args(args, tzd, torch.tensor),
                                 n_samples=n_samples, **kwargs)
    want = np.asarray(jnode.tensor)
    assert tuple(tnode.tensor.shape) == want.shape
    _close(tnode.tensor, want, 1e-12)
    _close(tbn.cond_log_prob("v"), jbn.cond_log_prob("v"), 1e-10)


@pytest.mark.parametrize("case", [c for c in SUGAR_CASES if c[6] is None],
                         ids=lambda c: c[0])
def test_torch_sampled_sugar_node_shapes_and_reproducibility(case):
    method, _, args, kwargs, _, _, _ = case
    draws = []
    for _ in range(2):
        bn = BayesianNet(key=11)
        node = getattr(bn, method)("v", *_sugar_args(args, tzd,
                                                     torch.tensor),
                                   n_samples=4, **kwargs)
        draws.append(node.tensor)
        assert tuple(node.tensor.shape) == (4,) + tuple(
            node.dist.batch_shape)
        assert bool(torch.isfinite(bn.cond_log_prob("v")).all())
    assert torch.equal(draws[0], draws[1])


def test_default_bijectors_resolve_as_in_jax():
    """ADVI's support-matching bijectors find the new classes by name."""
    from zhusuan_tpu.variational import autoguide as jag
    from zhusuan_tpu_torch.variational import autoguide as tag

    cases = [("HalfCauchy", (P23,)), ("LogNormal", (L23, P23)),
             ("Exponential", (P23,)), ("StudentT", (P23, L23, P23)),
             ("Cauchy", (L23, P23)), ("Weibull", (P23, P23)),
             ("TruncatedNormal", (L23, P23, L23 - 1.0, L23 + 1.0)),
             ("VonMises", (L23, P23))]
    for name, args in cases:
        jd, td = _pair(name, args)
        want = type(jag._default_bijector(jd)).__name__
        got = type(tag._default_bijector(td)).__name__
        assert got == want, name
    assert type(tag._default_bijector(_pair("HalfCauchy", (P23,))[1])) \
        .__name__ == "Softplus"
