"""Parity tests of the port's univariate distributions
(``zhusuan_tpu_torch/distributions/univariate.py``) against the JAX
package's, on the CPU in float64.

What is held, and to what:

- ``log_prob`` of every class but ``Normal``, ``Bernoulli`` and ``Gamma``
  (``FoldNormal``, ``Categorical``, ``Uniform``, ``Beta``, ``Poisson``,
  ``Binomial``, ``InverseGamma``, ``Laplace``, ``BinConcrete``) on the
  same numpy inputs, with batch shapes, ``group_ndims``, out-of-support values and leading
  sample axes: 1e-12, or 1e-10 where differences of ``lgamma`` enter (Beta,
  Poisson, Binomial, InverseGamma), since the two libraries' ``lgamma``
  round differently and the differences cancel;
- samples of every class whose base draws can be fed in (``FoldNormal``,
  ``Uniform``, ``Laplace``, ``BinConcrete``, ``Categorical``, small-``n``
  ``Binomial``): the JAX package's own draws, rebuilt from its key, go
  through ``eps=`` and the samples agree to 1e-12 (indices exactly);
- samples of the rest (``Beta``, ``Poisson``, large-``n`` ``Binomial``,
  ``InverseGamma``) and of every class once more from the port's own
  generator: mean and variance within 4 standard errors of the exact
  values at a fixed seed;
- the gradient of ``log_prob`` with respect to every float parameter, to
  the same tolerance as the value, with and without
  ``use_path_derivative`` (which detaches them: 0 on both sides);
- reparameterized sample gradients against their analytic derivatives;
- the JAX tests' cases (``tests/distributions/test_univariate.py``): the
  checks, their messages, scipy's densities, the support and limit cases.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats
import torch

from zhusuan_tpu import distributions as jzd
from zhusuan_tpu_torch import distributions as tzd
from zhusuan_tpu_torch.distributions import utils as tutils

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TINY = float(np.finfo(np.float64).tiny)
TOL = 1e-12
TOL_LGAMMA = 1e-10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _pair(name, args, kwargs=None):
    """The JAX and the port's distribution ``name`` on the same arguments
    (numpy arrays become float64 arrays on each side; ints stay ints)."""
    kwargs = kwargs or {}

    def conv(v, to):
        return to(v.copy()) if isinstance(v, np.ndarray) else v

    jd = getattr(jzd, name)(*[conv(a, jnp.asarray) for a in args],
                            **{k: conv(v, jnp.asarray)
                               for k, v in kwargs.items()})
    td = getattr(tzd, name)(*[conv(a, torch.tensor) for a in args],
                            **{k: conv(v, torch.tensor)
                               for k, v in kwargs.items()})
    return jd, td


RNG = np.random.RandomState(0)
A23 = RNG.randn(2, 3)
P23 = 0.5 + RNG.rand(2, 3) * 2.0
U23 = 0.05 + 0.9 * RNG.rand(2, 3)

# (id, class, args, kwargs, given, tol); given broadcasts to the batch,
# sometimes with a leading sample axis, and includes values outside the
# support where the class has a boundary.
LOG_PROB_CASES = [
    ("foldnormal-std", "FoldNormal", (A23,), {"std": P23},
     np.abs(RNG.randn(4, 2, 3)), TOL),
    ("foldnormal-logstd-g1", "FoldNormal", (A23,),
     {"logstd": RNG.randn(2, 3) * 0.3, "group_ndims": 1},
     np.array([[0.3, -0.2, 1.5], [2.0, 0.0, 0.7]]), TOL),
    ("categorical", "Categorical", (RNG.randn(2, 3, 4),), {},
     np.array([[0, 3, 1], [2, 2, 0]]), TOL),
    ("categorical-samples-out-of-support", "Categorical",
     (RNG.randn(3, 4),), {}, np.array([[0, 4, -1], [3, 2, 7]]), TOL),
    ("categorical-scalar-given-g1", "Categorical", (RNG.randn(3, 5),),
     {"group_ndims": 1}, np.array(2), TOL),
    ("uniform", "Uniform", (np.array([-1.0, 0.5]), np.array([3.0, 0.75])),
     {}, np.array([[0.0, 0.6], [5.0, 0.5], [-1.0, 0.75]]), TOL),
    ("uniform-g1", "Uniform", (A23 - 2.0, A23 + 2.0), {"group_ndims": 1},
     A23 + 0.5, TOL),
    ("beta", "Beta", (P23, P23[::-1]), {}, U23, TOL_LGAMMA),
    ("beta-g2-samples", "Beta", (P23, 1.5), {"group_ndims": 2},
     0.05 + 0.9 * RNG.rand(5, 2, 3), TOL_LGAMMA),
    ("poisson", "Poisson", (np.array([0.5, 4.0, 20.0]),), {},
     np.array([[0, 3, 25], [1, 0, 19]]), TOL_LGAMMA),
    ("poisson-g1", "Poisson", (P23,), {"group_ndims": 1},
     np.array([[0, 1, 2], [3, 4, 5]]), TOL_LGAMMA),
    ("binomial", "Binomial", (A23, 10), {},
     np.array([[3, 8, 0], [10, 5, 1]]), TOL_LGAMMA),
    ("binomial-large-n-g1", "Binomial", (A23, 200), {"group_ndims": 1},
     np.array([[30, 180, 100], [0, 200, 77]]), TOL_LGAMMA),
    ("inversegamma", "InverseGamma", (P23, P23.T.reshape(2, 3)), {},
     U23 * 3.0, TOL_LGAMMA),
    ("inversegamma-g1", "InverseGamma", (P23, 0.7), {"group_ndims": 1},
     0.1 + RNG.rand(4, 2, 3), TOL_LGAMMA),
    ("laplace", "Laplace", (A23, P23), {}, RNG.randn(3, 2, 3) * 3.0, TOL),
    ("laplace-g2", "Laplace", (A23, 2.5), {"group_ndims": 2},
     RNG.randn(2, 3), TOL),
    ("binconcrete", "BinConcrete", (np.array(0.7), A23), {}, U23, TOL),
    ("binconcrete-g1-samples", "BinConcrete", (np.array(0.3), A23),
     {"group_ndims": 1}, 0.01 + 0.98 * RNG.rand(4, 2, 3), TOL),
]


@pytest.mark.parametrize("case", LOG_PROB_CASES, ids=lambda c: c[0])
def test_log_prob_matches_jax(case):
    """The density of every new class at the same inputs; infinities
    (out of support) must agree as infinities."""
    _, name, args, kwargs, given, tol = case
    jd, td = _pair(name, args, kwargs)
    assert tuple(td.batch_shape) == tuple(jd.batch_shape)
    assert tuple(td.value_shape) == tuple(jd.value_shape)
    if given.dtype.kind == "i":
        want = jd.log_prob(jnp.asarray(given, jnp.int32))
        got = td.log_prob(torch.tensor(given, dtype=torch.int32))
    else:
        want = jd.log_prob(jnp.asarray(given))
        got = td.log_prob(torch.tensor(given))
    assert got.dtype == torch.float64
    want, got = np.asarray(want), _np(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    assert finite.any()
    _close(got[finite], want[finite], tol)
    _close(np.exp(got[finite]), np.asarray(jd.prob(
        jnp.asarray(given)))[finite] if given.dtype.kind != "i"
        else np.exp(want[finite]), tol)


def test_discrete_float_given_scores_in_param_dtype():
    """A float ``given`` to a discrete head scores in the parameter dtype
    (soft counts are not truncated), as in the JAX package."""
    jd, td = _pair("Poisson", (np.array([2.0, 3.0]),))
    x = np.array([1.5, 2.25])
    _close(td.log_prob(torch.tensor(x)), jd.log_prob(jnp.asarray(x)),
           TOL_LGAMMA)


def _float_slots(args, kwargs):
    """The positions (int) and names (str) of the float array arguments."""
    slots = [i for i, a in enumerate(args)
             if isinstance(a, np.ndarray) and a.dtype.kind == "f"]
    slots += [k for k, v in kwargs.items()
              if isinstance(v, np.ndarray) and v.dtype.kind == "f"]
    return slots


def _with(args, kwargs, slots, values):
    args, kwargs = list(args), dict(kwargs)
    for slot, v in zip(slots, values):
        if isinstance(slot, int):
            args[slot] = v
        else:
            kwargs[slot] = v
    return args, kwargs


def _takes_path_derivative(name):
    return "use_path_derivative" in inspect.signature(
        getattr(tzd, name)).parameters


@pytest.mark.parametrize("case,path_derivative", [
    (c, p) for c in LOG_PROB_CASES for p in (False, True)
    if not p or _takes_path_derivative(c[1])],
    ids=lambda v: v[0] if isinstance(v, tuple) else (
        "path-derivative" if v else "plain"))
def test_log_prob_parameter_gradients_match_jax(case, path_derivative):
    """The gradient of ``sum(log_prob(given))`` with respect to every
    float parameter, what the ELBO's and the samplers' gradients are made
    of; with ``use_path_derivative=True`` (where the class takes it) the
    parameters are detached inside ``log_prob`` on both sides."""
    _, name, args, kwargs, given, tol = case
    if path_derivative:
        kwargs = dict(kwargs, use_path_derivative=True)
    slots = _float_slots(args, kwargs)
    values = [args[s] if isinstance(s, int) else kwargs[s] for s in slots]
    int_given = given.dtype.kind == "i"

    def jf(*vals):
        a, k = _with(args, kwargs, slots, vals)
        dist = getattr(jzd, name)(*[jnp.asarray(v) if isinstance(
            v, np.ndarray) else v for v in a], **k)
        g = jnp.asarray(given, jnp.int32) if int_given else jnp.asarray(
            given)
        return jnp.sum(dist.log_prob(g))

    want = jax.grad(jf, argnums=tuple(range(len(values))))(
        *[jnp.asarray(v) for v in values])
    leaves = [torch.tensor(v.copy(), requires_grad=True) for v in values]
    a, k = _with(args, kwargs, slots, leaves)
    dist = getattr(tzd, name)(*[torch.tensor(v.copy()) if isinstance(
        v, np.ndarray) else v for v in a], **k)
    g = torch.tensor(given, dtype=torch.int32) if int_given else \
        torch.tensor(given)
    total = torch.sum(dist.log_prob(g))
    got = (torch.autograd.grad(total, leaves, allow_unused=True)
           if total.requires_grad else [None] * len(leaves))
    for leaf_grad, w in zip(got, want):
        w = np.asarray(w)
        if leaf_grad is None:  # detached on the port's side
            leaf_grad = torch.zeros(w.shape, dtype=torch.float64)
        if path_derivative:
            assert not np.any(w), "JAX's gradient is not 0"
        _close(leaf_grad, w, tol)


def _open_uniform(key, shape):
    return jax.random.uniform(key, shape, jnp.float64, minval=TINY,
                              maxval=1.0)


# (id, class, args, kwargs, n_samples, the JAX base draws from (key,
# sample shape)). The sample shape excludes the sample axis when
# n_samples is None.
EPS_CASES = [
    ("foldnormal", "FoldNormal", (A23,), {"std": P23}, 5,
     lambda k, s: jax.random.normal(k, s, jnp.float64)),
    ("foldnormal-unfolded", "FoldNormal", (A23,),
     {"std": P23, "fold_samples": False}, 3,
     lambda k, s: jax.random.normal(k, s, jnp.float64)),
    ("uniform", "Uniform", (A23, A23 + P23), {}, 4,
     lambda k, s: jax.random.uniform(k, s, jnp.float64)),
    ("uniform-single", "Uniform", (A23, A23 + P23), {}, None,
     lambda k, s: jax.random.uniform(k, s, jnp.float64)),
    ("laplace", "Laplace", (A23, P23), {}, 6, _open_uniform),
    ("binconcrete", "BinConcrete", (np.array(0.4), A23), {}, 5,
     _open_uniform),
    ("binconcrete-single", "BinConcrete", (np.array(2.0), A23), {}, None,
     _open_uniform),
]


@pytest.mark.parametrize("case", EPS_CASES, ids=lambda c: c[0])
def test_samples_from_jax_base_draws_match_jax(case):
    _, name, args, kwargs, n_samples, base = case
    jd, td = _pair(name, args, kwargs)
    shape = ((1 if n_samples is None else n_samples,)
             + tuple(jd.batch_shape))
    eps = np.asarray(base(KEY, shape))
    if n_samples is None:
        eps = eps[0]
    want = jd.sample(KEY, n_samples)
    got = td.sample(None, n_samples, eps=torch.tensor(eps))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("n_samples", [None, 1, 7])
def test_categorical_samples_from_jax_gumbels(n_samples):
    """``jax.random.categorical`` is ``argmax(logits + Gumbel)``; its
    Gumbels come from open-interval uniforms of shape ``sample + batch +
    [K]``, which the port takes through ``eps=``."""
    logits = RNG.randn(3, 2, 5)
    jd, td = _pair("Categorical", (logits,))
    shape = (1 if n_samples is None else n_samples,) + (3, 2, 5)
    u = np.asarray(_open_uniform(KEY, shape))
    if n_samples is None:
        u = u[0]
    want = np.asarray(jd.sample(KEY, n_samples))
    got = td.sample(None, n_samples, eps=torch.tensor(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("n_samples", [None, 4])
def test_small_n_binomial_samples_from_jax_uniforms(n_samples):
    """n <= 64: the sum over n of ``u < sigmoid(logits)``, u of shape
    ``(n_samples, n) + batch``."""
    jd, td = _pair("Binomial", (A23, 9))
    shape = (1 if n_samples is None else n_samples, 9) + (2, 3)
    u = np.asarray(jax.random.uniform(KEY, shape, jnp.float64))
    if n_samples is None:
        u = u[0]
    want = np.asarray(jd.sample(KEY, n_samples))
    got = td.sample(None, n_samples, eps=torch.tensor(u))
    np.testing.assert_array_equal(_np(got), want)


def _moments_within(samples, mean, var, n_se=4.0):
    """Sample mean within ``n_se`` standard errors of ``mean`` and sample
    variance within ``n_se`` of its own (from the sample's fourth central
    moment) of ``var``, per batch element."""
    x = _np(samples).astype(np.float64)
    n = x.shape[0]
    m = x.mean(0)
    v = x.var(0)
    m4 = ((x - m) ** 4).mean(0)
    se_mean = np.sqrt(var / n)
    se_var = np.sqrt(np.maximum(m4 - v ** 2, 1e-300) / n)
    assert np.all(np.abs(m - mean) < n_se * se_mean), (m, mean, se_mean)
    assert np.all(np.abs(v - var) < n_se * se_var), (v, var, se_var)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


ALPHA = np.array([0.7, 2.0, 5.0])
BETA = np.array([1.5, 0.5, 3.0])

# (id, class, args, kwargs, exact mean, exact variance)
MOMENT_CASES = [
    ("foldnormal", "FoldNormal", (np.array([0.0, 1.0, -2.0]),),
     {"std": np.array([1.0, 0.5, 2.0])}, None, None),
    ("categorical", "Categorical", (np.log(np.array([[0.2, 0.5, 0.3]])),),
     {}, np.array([1.1]), np.array([0.49])),
    ("uniform", "Uniform", (np.array([-1.0, 2.0]), np.array([3.0, 2.5])),
     {}, np.array([1.0, 2.25]), np.array([16.0, 0.25]) / 12.0),
    ("gamma", "Gamma", (ALPHA, BETA), {}, ALPHA / BETA, ALPHA / BETA ** 2),
    ("beta", "Beta", (ALPHA, BETA), {}, ALPHA / (ALPHA + BETA),
     ALPHA * BETA / ((ALPHA + BETA) ** 2 * (ALPHA + BETA + 1))),
    ("beta-reparameterized", "Beta", (ALPHA, BETA),
     {"is_reparameterized": True}, ALPHA / (ALPHA + BETA),
     ALPHA * BETA / ((ALPHA + BETA) ** 2 * (ALPHA + BETA + 1))),
    ("poisson", "Poisson", (np.array([0.5, 7.0, 40.0]),), {},
     np.array([0.5, 7.0, 40.0]), np.array([0.5, 7.0, 40.0])),
    ("binomial-small-n", "Binomial", (np.array([0.4, -1.0]), 20), {},
     20 * _sig(np.array([0.4, -1.0])),
     20 * _sig(np.array([0.4, -1.0])) * (1 - _sig(np.array([0.4, -1.0])))),
    ("binomial-large-n", "Binomial", (np.array([0.4, -1.0]), 500), {},
     500 * _sig(np.array([0.4, -1.0])),
     500 * _sig(np.array([0.4, -1.0])) * (1 - _sig(np.array([0.4, -1.0])))),
    ("inversegamma", "InverseGamma", (np.array([5.0, 7.0]),
                                      np.array([2.0, 0.5])), {},
     np.array([2.0, 0.5]) / np.array([4.0, 6.0]),
     np.array([2.0, 0.5]) ** 2 / (np.array([4.0, 6.0]) ** 2
                                  * np.array([3.0, 5.0]))),
    ("laplace", "Laplace", (np.array([1.0, -2.0]), np.array([2.0, 0.3])),
     {}, np.array([1.0, -2.0]), 2.0 * np.array([2.0, 0.3]) ** 2),
    ("binconcrete", "BinConcrete", (np.array(1.0), np.array([0.0, 1.5])),
     {}, _sig(np.array([0.0, 1.5])), None),
]


def _foldnormal_moments(mu, sd):
    from scipy.special import erf
    mean = (sd * np.sqrt(2 / np.pi) * np.exp(-mu ** 2 / (2 * sd ** 2))
            + mu * erf(mu / np.sqrt(2 * sd ** 2)))
    return mean, mu ** 2 + sd ** 2 - mean ** 2


@pytest.mark.parametrize("case", MOMENT_CASES, ids=lambda c: c[0])
def test_sample_moments_from_the_port_generator(case):
    """2e5 draws from the port's own generator (torch's samplers where the
    JAX package uses its own), mean and variance within 4 standard errors
    of the exact values."""
    _, name, args, kwargs, mean, var = case
    _, td = _pair(name, args, kwargs)
    x = td.sample(_gen(3), 200_000)
    assert tuple(x.shape) == (200_000,) + tuple(td.batch_shape)
    if name == "FoldNormal":
        mean, var = _foldnormal_moments(args[0], kwargs["std"])
        assert bool((x >= 0).all())
    if name == "BinConcrete":
        # At temperature 1 the mean of sigmoid(logits + L) is not simple;
        # P(x > 1/2) = sigmoid(logits) is.
        frac = (x > 0.5).double()
        _moments_within(frac, mean, mean * (1 - mean))
        return
    _moments_within(x, mean, var)


def test_samples_without_eps_or_generator_raise():
    _, td = _pair("Beta", (ALPHA, BETA))
    with pytest.raises(ValueError, match="takes no eps"):
        td.sample(_gen(), 2, eps=torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="torch.Generator"):
        td.sample(None, 2)
    _, tb = _pair("Binomial", (A23, 100))
    with pytest.raises(ValueError, match="takes no eps"):
        tb.sample(_gen(), 1, eps=torch.zeros(1, 100, 2, 3))
    _, tl = _pair("Laplace", (A23, P23))
    with pytest.raises(ValueError, match="eps must have shape"):
        tl.sample(None, 2, eps=torch.zeros(3, 2, 3))


def test_non_reparameterized_samples_carry_no_gradient():
    a = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    for dist in (tzd.Beta(a, a), tzd.Poisson(a), tzd.Categorical(a),
                 tzd.Binomial(a, 5), tzd.Gamma(a, a),
                 tzd.Laplace(a, a, is_reparameterized=False)):
        assert not dist.sample(_gen(), 3).requires_grad


def test_reparameterized_gradients_match_analytic_derivatives():
    """d/dparam of a Monte Carlo mean of reparameterized draws against the
    derivative of the exact mean: Uniform and Laplace exactly (the draw is
    linear in the parameters), FoldNormal and BinConcrete through the
    JAX package's gradient on the same base draws, Beta, Gamma and
    InverseGamma (torch's implicit gamma gradient) within 4 standard
    errors."""
    # Uniform: E[x] = (lo + hi) / 2.
    lo = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    hi = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    tzd.Uniform(lo, hi).sample(_gen(), 1000).mean().backward()
    u = tzd.Uniform(torch.zeros((), dtype=torch.float64),
                    1.0).sample(_gen(), 1000)  # the same draws
    _close(hi.grad, u.double().mean(), 1e-12)
    _close(lo.grad, 1 - u.double().mean(), 1e-12)
    # Laplace: d x / d loc = 1.
    loc = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    tzd.Laplace(loc, 2.0).sample(_gen(), 100).mean().backward()
    _close(loc.grad, 1.0, 1e-12)
    # FoldNormal and BinConcrete: the JAX gradient on the same draws.
    mu0, sd0 = 0.3, 1.2
    eps = np.asarray(jax.random.normal(KEY, (50,), jnp.float64))

    def jfold(mu):
        return jnp.mean(jzd.FoldNormal(mu, std=jnp.float64(sd0)).sample(
            KEY, 50))

    mu = torch.tensor(mu0, dtype=torch.float64, requires_grad=True)
    tzd.FoldNormal(mu, std=sd0).sample(None, 50, eps=torch.tensor(
        eps)).mean().backward()
    _close(mu.grad, jax.grad(jfold)(jnp.float64(mu0)), 1e-12)
    u = np.asarray(_open_uniform(KEY, (40, 2)))

    def jbc(t, lg):
        return jnp.mean(jzd.BinConcrete(t, lg).sample(KEY, 40) ** 2)

    t = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    lg = torch.tensor([0.2, -1.0], dtype=torch.float64, requires_grad=True)
    (tzd.BinConcrete(t, lg).sample(None, 40, eps=torch.tensor(u)) ** 2
     ).mean().backward()
    jt, jl = jax.grad(jbc, argnums=(0, 1))(jnp.float64(0.6),
                                           jnp.asarray([0.2, -1.0]))
    _close(t.grad, jt, 1e-12)
    _close(lg.grad, jl, 1e-12)
    # Gamma-based: d E[x] / d alpha from one alpha a draw, so that the
    # per-draw derivatives (torch's implicit gradient) give their own
    # standard error.
    n = 200_000
    for name, a0, b0, dmean in (
            ("Gamma", 2.5, 1.5, 1 / 1.5),
            ("InverseGamma", 4.0, 2.0, -2.0 / 3.0 ** 2),
            ("Beta", 2.0, 3.0, 3.0 / 5.0 ** 2)):
        a = torch.full((n,), a0, dtype=torch.float64, requires_grad=True)
        dist = getattr(tzd, name)(a, torch.tensor(b0, dtype=torch.float64),
                                  is_reparameterized=True)
        dist.sample(_gen(7)).sum().backward()
        d = a.grad
        assert bool(torch.isfinite(d).all())
        se = float(d.std()) / np.sqrt(n)
        assert abs(float(d.mean()) - dmean) < 4 * se, (
            name, float(d.mean()), dmean, se)


# --------------------------------------------------------------------- #
# The JAX tests' cases (tests/distributions/test_univariate.py)
# --------------------------------------------------------------------- #
def test_foldnormal_vs_scipy_and_checks():
    mean, std, x = np.array([0.5, 1.0]), np.array([1.0, 2.0]), \
        np.array([0.3, 2.5])
    lp = tzd.FoldNormal(torch.tensor(mean), std=torch.tensor(std)).log_prob(
        torch.tensor(x))
    _close(lp, stats.foldnorm.logpdf(x, mean / std, scale=std), 1e-8)
    with pytest.raises(ValueError, match="keyword arguments"):
        tzd.FoldNormal(0.0, 1.0)
    with pytest.raises(ValueError, match="Exactly one"):
        tzd.FoldNormal(0.0)
    x = tzd.FoldNormal(torch.tensor(-2.0, dtype=torch.float64),
                       std=1.0).sample(_gen(), 1000)
    assert bool((x >= 0).all())


def test_categorical_vs_softmax_and_checks():
    with pytest.raises(ValueError, match="at least 1-D"):
        tzd.Categorical(torch.tensor(1.0))
    logits = np.array([[0.0, 1.0, 2.0], [2.0, 0.5, -1.0]])
    lp = tzd.Categorical(torch.tensor(logits)).log_prob(
        torch.tensor([2, 0], dtype=torch.int32))
    expected = (logits - np.log(np.exp(logits).sum(-1, keepdims=True)))[
        [0, 1], [2, 0]]
    _close(lp, expected, 1e-10)
    dist = tzd.Categorical(torch.zeros(4, 3))
    lp = dist.log_prob(torch.tensor(1, dtype=torch.int32))
    assert tuple(lp.shape) == (4,)
    _close(lp, np.full(4, np.log(1 / 3)), 1e-6)
    assert tzd.Discrete is tzd.Categorical
    x = tzd.Categorical(torch.tensor([0.0, 1.0, 2.0],
                                     dtype=torch.float64)).sample(
        _gen(), 100_000)
    freqs = np.bincount(_np(x), minlength=3) / 100_000
    p = np.exp([0.0, 1.0, 2.0]) / np.exp([0.0, 1.0, 2.0]).sum()
    np.testing.assert_allclose(freqs, p, atol=0.01)


def test_uniform_support_and_range():
    dist = tzd.Uniform(torch.tensor(-1.0, dtype=torch.float64),
                       torch.tensor(3.0, dtype=torch.float64))
    _close(dist.log_prob(torch.tensor(0.0, dtype=torch.float64)),
           np.log(0.25), 1e-10)
    assert np.isneginf(float(dist.log_prob(torch.tensor(5.0))))
    x = tzd.Uniform(torch.tensor(2.0), torch.tensor(5.0)).sample(_gen(),
                                                                 1000)
    assert bool(((x >= 2.0) & (x < 5.0)).all())


@pytest.mark.parametrize("name,scipy_lp", [
    ("Beta", lambda x, a, b: stats.beta.logpdf(x, a, b)),
    ("InverseGamma", lambda x, a, b: stats.invgamma.logpdf(x, a, scale=b)),
    ("Gamma", lambda x, a, b: stats.gamma.logpdf(x, a, scale=1 / b)),
])
def test_alpha_beta_heads_vs_scipy(name, scipy_lp):
    a, b, x = np.array([0.5, 2.0]), np.array([0.5, 3.0]), \
        np.array([0.3, 0.6])
    lp = getattr(tzd, name)(torch.tensor(a), torch.tensor(b)).log_prob(
        torch.tensor(x))
    _close(lp, scipy_lp(x, a, b), 1e-8)


def test_poisson_and_binomial_vs_scipy():
    rate = np.array([0.5, 4.0, 20.0])
    lp = tzd.Poisson(torch.tensor(rate)).log_prob(
        torch.tensor([0, 3, 25], dtype=torch.int32))
    _close(lp, stats.poisson.logpmf([0, 3, 25], rate), 1e-8)
    logits = np.array([-0.5, 1.2])
    lp = tzd.Binomial(torch.tensor(logits), n_experiments=10).log_prob(
        torch.tensor([3, 8], dtype=torch.int32))
    _close(lp, stats.binom.logpmf([3, 8], 10, _sig(logits)), 1e-8)


@pytest.mark.parametrize("bad,match", [
    (0, "positive"), (-3, "positive"), (2.5, "positive int or a 0-D"),
    (np.array([3, 4]), "scalar"), (np.array(3.0), "int scalar"),
])
def test_binomial_trial_count_checks(bad, match):
    with pytest.raises(ValueError, match=match):
        tzd.Binomial(0.0, bad)
    with pytest.raises(ValueError, match=match):
        jzd.Binomial(0.0, jnp.asarray(bad) if isinstance(
            bad, np.ndarray) else bad)


def test_binomial_tensor_mode_scores_and_samples():
    """A 0-D integer tensor ``n`` (the reference's tensor mode) scores as
    the int does and samples through ``torch.binomial``."""
    jd, td = _pair("Binomial", (A23, np.array(12)))
    assert isinstance(td.n_experiments, torch.Tensor)
    x = np.array([[3, 12, 0], [5, 6, 7]])
    _close(td.log_prob(torch.tensor(x, dtype=torch.int32)),
           jd.log_prob(jnp.asarray(x, jnp.int32)), TOL_LGAMMA)
    s = td.sample(_gen(), 50)
    assert tuple(s.shape) == (50, 2, 3)
    assert bool(((s >= 0) & (s <= 12)).all())


def test_laplace_vs_scipy_and_moments():
    loc, scale, x = np.array([0.0, -1.0]), np.array([1.0, 2.5]), \
        np.array([0.5, 3.0])
    lp = tzd.Laplace(torch.tensor(loc), torch.tensor(scale)).log_prob(
        torch.tensor(x))
    _close(lp, stats.laplace.logpdf(x, loc, scale), 1e-8)


def test_binconcrete_checks_support_density_and_limit():
    with pytest.raises(ValueError, match="scalar"):
        tzd.BinConcrete(torch.ones(2), torch.zeros(3))
    assert tzd.BinGumbelSoftmax is tzd.BinConcrete
    x = tzd.BinConcrete(torch.tensor(0.5, dtype=torch.float64),
                        torch.tensor([0.0, 2.0],
                                     dtype=torch.float64)).sample(
        _gen(), 1000)
    assert bool(((x > 0) & (x < 1)).all())
    dist = tzd.BinConcrete(torch.tensor(0.7, dtype=torch.float64),
                           torch.tensor(0.4, dtype=torch.float64))
    grid = torch.linspace(1e-5, 1 - 1e-5, 20001, dtype=torch.float64)
    assert abs(float(torch.trapezoid(torch.exp(dist.log_prob(grid)),
                                     grid)) - 1.0) < 1e-3
    cold = tzd.BinConcrete(torch.tensor(0.01, dtype=torch.float64),
                           torch.tensor(1.2, dtype=torch.float64))
    frac = float((cold.sample(_gen(), 100_000) > 0.5).double().mean())
    assert abs(frac - _sig(1.2)) < 0.01


def test_dtype_checks_and_int_dtype_samples():
    with pytest.raises(TypeError, match="same dtype"):
        tzd.Beta(torch.ones(2, dtype=torch.float32),
                 torch.ones(2, dtype=torch.float64))
    with pytest.raises(TypeError, match="float dtype"):
        tzd.Laplace(torch.ones(2, dtype=torch.int32), 1.0)
    assert tzd.Poisson(torch.ones(3)).sample(_gen(), 2).dtype == torch.int32
    assert tzd.Categorical(torch.zeros(3), dtype=torch.int64).sample(
        _gen(), 2).dtype == torch.int64
    assert tzd.Binomial(torch.zeros(3), 4, dtype=torch.float32).sample(
        _gen(), 2).dtype == torch.float32


@pytest.mark.parametrize("make,given", [
    (lambda: tzd.FoldNormal(0.0, std=float("nan"), check_numerics=True),
     0.5),
    (lambda: tzd.Uniform(1.0, 1.0, check_numerics=True), 1.0),
    (lambda: tzd.Laplace(0.0, -1.0, check_numerics=True), 0.5),
    (lambda: tzd.Beta(1.0, 1.0, check_numerics=True), -0.5),
    (lambda: tzd.InverseGamma(1.0, 1.0, check_numerics=True), -0.5),
    (lambda: tzd.Poisson(-1.0, check_numerics=True), 1.0),
    (lambda: tzd.BinConcrete(-1.0, 0.0, check_numerics=True), 0.5),
], ids=["foldnormal", "uniform", "laplace", "beta", "inversegamma",
        "poisson", "binconcrete"])
def test_check_numerics_raises_on_nan(make, given):
    with pytest.raises(FloatingPointError):
        make().log_prob(torch.tensor(given))


# --------------------------------------------------------------------- #
# distributions/utils.py
# --------------------------------------------------------------------- #
def test_utils_match_jax():
    from zhusuan_tpu.distributions import utils as jutils

    ks = np.array([[2.0, 3.0, 5.0], [0.0, 1.0, 4.0]])
    n = ks.sum(-1)
    _close(tutils.log_combination(torch.tensor(n), torch.tensor(ks)),
           jutils.log_combination(jnp.asarray(n), jnp.asarray(ks)),
           TOL_LGAMMA)
    x, y = tutils.explicit_broadcast(torch.zeros(3, 1), torch.ones(4))
    assert tuple(x.shape) == tuple(y.shape) == (3, 4)
    with pytest.raises(ValueError, match="a and b cannot broadcast"):
        tutils.maybe_explicit_broadcast(torch.zeros(3), torch.zeros(4),
                                        "a", "b")
    assert tutils.is_same_dynamic_shape(torch.zeros(2, 3), np.ones((2, 3)))
    assert not tutils.is_same_dynamic_shape(torch.zeros(2, 3),
                                            torch.zeros(3, 2))
    assert tutils.assert_same_float_and_int_dtype(
        [(torch.ones(2, dtype=torch.int32), "a"), (3, "b")]) == torch.int32
    with pytest.raises(TypeError, match="float or int dtype"):
        tutils.assert_same_float_and_int_dtype(
            [(torch.ones(2, dtype=torch.bool), "a")])
    with pytest.raises(TypeError, match="same dtype"):
        tutils.assert_same_float_and_int_dtype(
            [(torch.ones(2, dtype=torch.int32), "a"),
             (torch.ones(2, dtype=torch.int64), "b")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_open_interval_uniform_never_returns_zero(dtype):
    """``torch.rand`` draws on [0, 1); the port maps a 0 to ``tiny`` as the
    JAX package's ``minval=tiny`` does, and keeps everything below 1."""
    tiny = torch.finfo(dtype).tiny
    u = tutils.open_interval_standard_uniform(_gen(), (100_000,), dtype)
    assert u.dtype == dtype
    assert bool((u >= tiny).all() and (u < 1).all())

    class ZeroGen:  # torch.rand's lowest value, forced
        device = torch.device("cpu")

    real_rand = torch.rand
    try:
        torch.rand = lambda *a, **k: torch.zeros(
            a[0], dtype=k["dtype"])
        z = tutils.open_interval_standard_uniform(ZeroGen(), (4,), dtype)
    finally:
        torch.rand = real_rand
    assert bool((z == tiny).all())
    assert bool(torch.isfinite(torch.log(z)).all())
