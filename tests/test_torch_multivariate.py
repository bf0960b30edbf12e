"""Parity tests of the port's multivariate distributions
(``zhusuan_tpu_torch/distributions/multivariate.py``) against the JAX
package's, on the CPU in float64.

What is held, and to what:

- ``log_prob`` of every class but ``MultivariateNormalCholesky``
  (``Multinomial``, ``UnnormalizedMultinomial``, ``OnehotCategorical``,
  ``Dirichlet``, ``ExpConcrete``, ``Concrete``,
  ``MatrixVariateNormalCholesky``, ``MultivariateStudentTCholesky``) on
  the same numpy inputs, with batch
  shapes, ``group_ndims`` and leading sample axes: 1e-12, or 1e-10 where
  ``lgamma`` enters (the multinomial coefficient, Dirichlet's ``lbeta``,
  the Concretes' ``lgamma(K)``, Student-t's normaliser);
- samples of every class whose base draws can be fed in
  (``OnehotCategorical``, ``ExpConcrete``, ``Concrete``,
  ``MatrixVariateNormalCholesky``, small-``n`` ``Multinomial``): the JAX
  package's own draws, rebuilt from its key, go through ``eps=`` and the
  samples agree to 1e-12 (counts exactly);
- samples of the rest (``Dirichlet``, large-``n`` ``Multinomial``,
  Student-t) from the port's own generator: moments within 4 standard
  errors of the exact values at a fixed seed;
- the gradient of ``log_prob`` with respect to every float parameter, to
  the same tolerance as the value, with and without
  ``use_path_derivative`` (which detaches them: 0 on both sides);
- reparameterized sample gradients against their analytic derivatives;
- the JAX tests' cases (``tests/distributions/test_multivariate.py``).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as stats
import torch

from zhusuan_tpu import distributions as jzd
from zhusuan_tpu_torch import BayesianNet
from zhusuan_tpu_torch import distributions as tzd

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)
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
    (numpy arrays become arrays of their dtype on each side; ints stay
    ints)."""
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


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tril(rng, *shape):
    """Lower-triangular factors with a positive diagonal."""
    n = shape[-1]
    a = rng.randn(*shape) * 0.3
    return np.tril(a, -1) + np.eye(n) * (0.5 + rng.rand(*shape[:-1], 1))


RNG = np.random.RandomState(1)
L34 = RNG.randn(3, 4)
ALPHA34 = 0.5 + 2.0 * RNG.rand(3, 4)


def _simplex(rng, *shape):
    x = rng.rand(*shape) + 0.05
    return x / x.sum(-1, keepdims=True)


def _onehot(idx, k):
    return np.eye(k, dtype=np.int64)[idx]


LOG_PROB_CASES = [
    ("multinomial", "Multinomial", (L34, 10), {},
     np.array([[2, 3, 5, 0], [10, 0, 0, 0], [1, 1, 4, 4]]), TOL_LGAMMA),
    ("multinomial-n-none", "Multinomial", (L34, None), {},
     np.array([[1, 0, 4, 2], [0, 0, 0, 3], [5, 5, 5, 5]]), TOL_LGAMMA),
    ("multinomial-tensor-n-g1", "Multinomial", (L34, np.array(7)),
     {"group_ndims": 1},
     np.array([[1, 2, 3, 1], [0, 0, 7, 0], [2, 2, 2, 1]]), TOL_LGAMMA),
    ("multinomial-unnormalized", "Multinomial", (L34, 6),
     {"normalize_logits": False},
     np.array([[1, 2, 3, 0], [0, 6, 0, 0], [2, 1, 2, 1]]), TOL_LGAMMA),
    ("unnormalized-multinomial", "UnnormalizedMultinomial", (L34,), {},
     np.array([[2, 3, 5, 0], [4, 0, 1, 1], [0, 0, 0, 9]]), TOL),
    ("unnormalized-multinomial-raw", "UnnormalizedMultinomial", (L34,),
     {"normalize_logits": False, "group_ndims": 1},
     np.array([[2, 3, 5, 0], [4, 0, 1, 1], [0, 0, 0, 9]]), TOL),
    ("onehot", "OnehotCategorical", (L34,), {},
     _onehot(np.array([[0, 3, 1], [2, 2, 0]]), 4), TOL),
    ("onehot-g1", "OnehotCategorical", (L34,), {"group_ndims": 1},
     _onehot(np.array([1, 3, 0]), 4), TOL),
    ("dirichlet", "Dirichlet", (ALPHA34,), {}, _simplex(RNG, 3, 4),
     TOL_LGAMMA),
    ("dirichlet-g1-samples", "Dirichlet", (ALPHA34,), {"group_ndims": 1},
     _simplex(RNG, 5, 3, 4), TOL_LGAMMA),
    ("expconcrete", "ExpConcrete", (np.array(0.8), L34), {},
     np.log(_simplex(RNG, 3, 4)), TOL_LGAMMA),
    ("expconcrete-g1-samples", "ExpConcrete", (np.array(0.3), L34),
     {"group_ndims": 1}, np.log(_simplex(RNG, 2, 3, 4)), TOL_LGAMMA),
    ("concrete", "Concrete", (np.array(0.8), L34), {},
     _simplex(RNG, 3, 4), TOL_LGAMMA),
    ("concrete-g1-samples", "Concrete", (np.array(1.7), L34),
     {"group_ndims": 1}, _simplex(RNG, 2, 3, 4), TOL_LGAMMA),
    ("matrixnormal", "MatrixVariateNormalCholesky",
     (RNG.randn(2, 3, 4), _tril(RNG, 2, 3, 3), _tril(RNG, 4, 4)), {},
     RNG.randn(5, 2, 3, 4), TOL),
    ("matrixnormal-g1", "MatrixVariateNormalCholesky",
     (RNG.randn(3, 2), _tril(RNG, 2, 3, 3), _tril(RNG, 2, 2, 2)),
     {"group_ndims": 1}, RNG.randn(2, 3, 2), TOL),
    ("student-t", "MultivariateStudentTCholesky",
     (np.array(4.5), RNG.randn(3), _tril(RNG, 3, 3)), {},
     RNG.randn(7, 3) * 2.0, TOL_LGAMMA),
    ("student-t-batched-df-g1", "MultivariateStudentTCholesky",
     (np.array([3.0, 7.5]), RNG.randn(2, 3), _tril(RNG, 2, 3, 3)),
     {"group_ndims": 1}, RNG.randn(4, 2, 3), TOL_LGAMMA),
]


@pytest.mark.parametrize("case", LOG_PROB_CASES, ids=lambda c: c[0])
def test_log_prob_matches_jax(case):
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
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want, tol)


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


EPS_CASES = [
    ("onehot", "OnehotCategorical", (L34,), {}, 6, _open_uniform),
    ("onehot-single", "OnehotCategorical", (L34,), {}, None,
     _open_uniform),
    ("expconcrete", "ExpConcrete", (np.array(0.6), L34), {}, 5,
     _open_uniform),
    ("concrete", "Concrete", (np.array(1.3), L34), {}, 5, _open_uniform),
    ("concrete-single", "Concrete", (np.array(0.5), L34), {}, None,
     _open_uniform),
    ("matrixnormal", "MatrixVariateNormalCholesky",
     (RNG.randn(2, 3, 4), _tril(RNG, 2, 3, 3), _tril(RNG, 4, 4)), {}, 4,
     lambda k, s: jax.random.normal(k, s, jnp.float64)),
]


@pytest.mark.parametrize("case", EPS_CASES, ids=lambda c: c[0])
def test_samples_from_jax_base_draws_match_jax(case):
    _, name, args, kwargs, n_samples, base = case
    jd, td = _pair(name, args, kwargs)
    shape = ((1 if n_samples is None else n_samples,)
             + tuple(jd.batch_shape) + tuple(jd.value_shape))
    eps = np.asarray(base(KEY, shape))
    if n_samples is None:
        eps = eps[0]
    want = jd.sample(KEY, n_samples)
    got = td.sample(None, n_samples, eps=torch.tensor(eps))
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)


@pytest.mark.parametrize("n_samples", [None, 3])
def test_small_n_multinomial_samples_from_jax_gumbels(n_samples):
    """n <= 64: the one-hot sum of ``n`` categorical draws, the Gumbels
    from uniforms of shape ``(n_samples, n) + batch + [K]``."""
    jd, td = _pair("Multinomial", (L34, 6))
    shape = (1 if n_samples is None else n_samples, 6, 3, 4)
    u = np.asarray(_open_uniform(KEY, shape))
    if n_samples is None:
        u = u[0]
    want = np.asarray(jd.sample(KEY, n_samples))
    got = td.sample(None, n_samples, eps=torch.tensor(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


def _within(x, mean, se, n_se=4.0):
    assert np.all(np.abs(x - mean) < n_se * se), (x, mean, se)


@pytest.mark.parametrize("n", [7, 300])
def test_multinomial_moments(n):
    """E[x] = n p, Var[x_k] = n p_k (1 - p_k), on both sampler branches
    (the categorical sum at 7, the conditional binomials at 300)."""
    logits = np.array([0.3, -0.2, 1.1, -2.0])
    p = np.exp(logits) / np.exp(logits).sum()
    _, td = _pair("Multinomial", (logits, n))
    x = _np(td.sample(_gen(2), 100_000)).astype(np.float64)
    assert np.all(x.sum(-1) == n)
    var = n * p * (1 - p)
    _within(x.mean(0), n * p, np.sqrt(var / x.shape[0]))
    m4 = ((x - x.mean(0)) ** 4).mean(0)
    _within(x.var(0), var, np.sqrt((m4 - x.var(0) ** 2) / x.shape[0]))


@pytest.mark.parametrize("reparameterized", [False, True])
def test_dirichlet_moments(reparameterized):
    alpha = np.array([2.0, 3.0, 4.0, 0.5])
    a0 = alpha.sum()
    _, td = _pair("Dirichlet", (alpha,),
                  {"is_reparameterized": reparameterized})
    x = _np(td.sample(_gen(4), 100_000))
    np.testing.assert_allclose(x.sum(-1), 1.0, rtol=1e-12)
    mean = alpha / a0
    var = alpha * (a0 - alpha) / (a0 ** 2 * (a0 + 1))
    _within(x.mean(0), mean, np.sqrt(var / x.shape[0]))
    m4 = ((x - x.mean(0)) ** 4).mean(0)
    _within(x.var(0), var, np.sqrt((m4 - x.var(0) ** 2) / x.shape[0]))


def test_onehot_and_concrete_class_frequencies():
    logits = np.array([0.0, 1.0, -0.5])
    p = np.exp(logits) / np.exp(logits).sum()
    _, td = _pair("OnehotCategorical", (logits,))
    x = _np(td.sample(_gen(5), 100_000)).astype(np.float64)
    assert np.all(x.sum(-1) == 1)
    _within(x.mean(0), p, np.sqrt(p * (1 - p) / x.shape[0]))
    # Concrete at a low temperature: the arg-max class follows p.
    _, tc = _pair("Concrete", (np.array(0.05), logits))
    top = np.argmax(_np(tc.sample(_gen(6), 100_000)), -1)
    freq = np.bincount(top, minlength=3) / top.size
    _within(freq, p, np.sqrt(p * (1 - p) / top.size))


def test_samples_without_eps_or_generator_raise():
    _, td = _pair("Dirichlet", (ALPHA34,))
    with pytest.raises(ValueError, match="takes no eps"):
        td.sample(_gen(), 1, eps=torch.zeros(1, 3, 4, dtype=torch.float64))
    _, tm = _pair("Multinomial", (L34, 100))
    with pytest.raises(ValueError, match="takes no eps"):
        tm.sample(_gen(), 1, eps=torch.zeros(1, 100, 3, 4))
    _, tt = _pair("MultivariateStudentTCholesky",
                  (np.array(4.0), np.zeros(2), np.eye(2)))
    with pytest.raises(ValueError, match="takes no eps"):
        tt.sample(_gen(), 1, eps=torch.zeros(1, 2))
    _, tc = _pair("Concrete", (np.array(0.5), L34))
    with pytest.raises(ValueError, match="torch.Generator or eps"):
        tc.sample(None, 2)


def test_reparameterized_gradients():
    """ExpConcrete/Concrete/MatrixVariateNormalCholesky: the JAX
    package's gradient on the same base draws, to 1e-12; Student-t:
    d mean(x_0) / d loc_0 = 1 exactly; Dirichlet: d E[x_0] / d alpha_0
    (torch's implicit gamma gradient, one alpha a draw) within 4 standard
    errors."""
    logits0, temp0 = np.array([0.2, -0.5, 1.0]), 0.7
    u = np.asarray(_open_uniform(KEY, (20, 3)))
    w = np.array([1.0, -2.0, 0.5])
    for name in ("ExpConcrete", "Concrete"):
        def jf(t, lg, name=name):
            x = getattr(jzd, name)(t, lg).sample(KEY, 20)
            return jnp.mean(jnp.sum(x * w, -1) ** 2)

        t = torch.tensor(temp0, dtype=torch.float64, requires_grad=True)
        lg = torch.tensor(logits0, requires_grad=True)
        x = getattr(tzd, name)(t, lg).sample(None, 20, eps=torch.tensor(u))
        (torch.sum(x * torch.tensor(w), -1) ** 2).mean().backward()
        jt, jl = jax.grad(jf, argnums=(0, 1))(jnp.float64(temp0),
                                              jnp.asarray(logits0))
        _close(t.grad, jt)
        _close(lg.grad, jl)
    mean0, ut, vt = RNG.randn(3, 2), _tril(RNG, 3, 3), _tril(RNG, 2, 2)
    eps = np.asarray(jax.random.normal(KEY, (6, 3, 2), jnp.float64))

    def jm(m, a, b):
        x = jzd.MatrixVariateNormalCholesky(m, a, b).sample(KEY, 6)
        return jnp.sum(jnp.sin(x))

    targs = [torch.tensor(v, requires_grad=True) for v in (mean0, ut, vt)]
    x = tzd.MatrixVariateNormalCholesky(*targs).sample(
        None, 6, eps=torch.tensor(eps))
    torch.sum(torch.sin(x)).backward()
    for got, want in zip(targs, jax.grad(jm, argnums=(0, 1, 2))(
            *[jnp.asarray(v) for v in (mean0, ut, vt)])):
        _close(got.grad, want)
    loc = torch.tensor([1.0, 0.0], dtype=torch.float64, requires_grad=True)
    tzd.MultivariateStudentTCholesky(
        torch.tensor(5.0, dtype=torch.float64), loc,
        torch.eye(2, dtype=torch.float64)).sample(_gen(2), 5000)[
        :, 0].mean().backward()
    _close(loc.grad, [1.0, 0.0])
    n = 200_000
    alpha = torch.tensor([2.0, 3.0], dtype=torch.float64).repeat(n, 1)
    alpha.requires_grad_(True)
    tzd.Dirichlet(alpha, is_reparameterized=True).sample(_gen(9))[
        :, 0].sum().backward()
    d = alpha.grad[:, 0]
    se = float(d.std()) / np.sqrt(n)
    assert abs(float(d.mean()) - 3.0 / 25.0) < 4 * se


# --------------------------------------------------------------------- #
# The JAX tests' cases (tests/distributions/test_multivariate.py)
# --------------------------------------------------------------------- #
def test_multinomial_vs_scipy_and_n_none():
    logits = torch.tensor([0.3, -0.2, 1.1], dtype=torch.float64)
    p = torch.softmax(logits, -1).numpy()
    dist = tzd.Multinomial(logits, n_experiments=10)
    _close(dist.log_prob(torch.tensor([2, 3, 5], dtype=torch.int32)),
           stats.multinomial.logpmf([2, 3, 5], 10, p), 1e-8)
    dist = tzd.Multinomial(logits, n_experiments=None)
    _close(dist.log_prob(torch.tensor([1, 0, 4], dtype=torch.int32)),
           stats.multinomial.logpmf([1, 0, 4], 5, p), 1e-8)
    with pytest.raises(ValueError, match="n_experiments"):
        dist.sample(_gen(), 2)
    s = tzd.Multinomial(torch.tensor([0.0, 1.0], dtype=torch.float64),
                        n_experiments=7).sample(_gen(), 1000)
    assert tuple(s.shape) == (1000, 2) and bool((s.sum(-1) == 7).all())


@pytest.mark.parametrize("bad,match", [
    (0, "None or a positive int"), (-1, "None or a positive int"),
    (np.array([1, 2]), "scalar"), (np.array(2.0), "int scalar"),
    ("ten", "None, a positive int, or a 0-D"),
])
def test_multinomial_trial_count_checks(bad, match):
    for zd, arr in ((tzd, torch.zeros(3)), (jzd, jnp.zeros(3))):
        with pytest.raises(ValueError, match=match):
            zd.Multinomial(arr, bad)


def test_unnormalized_multinomial_and_onehot():
    logits = torch.tensor([0.3, -0.2, 1.1], dtype=torch.float64)
    p = torch.softmax(logits, -1).numpy()
    dist = tzd.UnnormalizedMultinomial(logits)
    _close(dist.log_prob(torch.tensor([2, 3, 5], dtype=torch.int32)),
           np.sum(np.array([2, 3, 5]) * np.log(p)), 1e-8)
    with pytest.raises(NotImplementedError):
        dist.sample(_gen(), 1)
    assert tzd.BagofCategoricals is tzd.UnnormalizedMultinomial
    lg = torch.tensor([[0.5, -1.0, 2.0]], dtype=torch.float64)
    x = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    _close(tzd.OnehotCategorical(lg).log_prob(x),
           [torch.log_softmax(lg, -1)[0, 2].item()], 1e-8)
    s = tzd.OnehotCategorical(torch.tensor([0.0, 1.0, -0.5])).sample(
        _gen(), 500)
    assert tuple(s.shape) == (500, 3) and bool((s.sum(-1) == 1).all())
    assert tzd.OnehotDiscrete is tzd.OnehotCategorical
    for cls in (tzd.Multinomial, tzd.UnnormalizedMultinomial,
                tzd.OnehotCategorical):
        with pytest.raises(ValueError, match="at least 1-D"):
            cls(torch.tensor(1.0), *((3,) if cls is tzd.Multinomial
                                     else ()))


def test_dirichlet_vs_scipy_and_checks():
    with pytest.raises(ValueError, match="at least 2"):
        tzd.Dirichlet(torch.tensor([1.0]))
    with pytest.raises(ValueError, match="at least 1-D"):
        tzd.Dirichlet(torch.tensor(1.0))
    alpha, x = np.array([0.5, 2.0, 1.5]), np.array([0.2, 0.5, 0.3])
    _close(tzd.Dirichlet(torch.tensor(alpha)).log_prob(torch.tensor(x)),
           stats.dirichlet.logpdf(x, alpha), 1e-8)


def test_concrete_family_relations_and_domains():
    temp, logits = torch.tensor(0.8, dtype=torch.float64), \
        torch.tensor([0.2, -0.5, 1.0], dtype=torch.float64)
    y = np.log(np.array([0.3, 0.45, 0.25]))
    lp_exp = float(tzd.ExpConcrete(temp, logits).log_prob(torch.tensor(y)))
    lp_con = float(tzd.Concrete(temp, logits).log_prob(
        torch.tensor(np.exp(y))))
    np.testing.assert_allclose(lp_exp - np.sum(y), lp_con, rtol=1e-8)
    s = tzd.Concrete(torch.tensor(0.5, dtype=torch.float64),
                     torch.tensor([0.0, 1.0, 2.0],
                                  dtype=torch.float64)).sample(_gen(), 10_000)
    _close(s.sum(-1), np.ones(10_000), 1e-12)
    s = tzd.ExpConcrete(torch.tensor(0.7, dtype=torch.float64),
                        torch.tensor([0.0, 1.0, -1.0],
                                     dtype=torch.float64)).sample(
        _gen(), 1000)
    assert bool((s <= 0).all())
    _close(torch.logsumexp(s, -1), np.zeros(1000), 1e-12)
    cold = tzd.Concrete(torch.tensor(0.01, dtype=torch.float64),
                        torch.tensor([0.0, 1.0], dtype=torch.float64))
    frac = float((cold.sample(_gen(), 100_000)[:, 1] > 0.5).double().mean())
    assert abs(frac - 1 / (1 + np.exp(-1.0))) < 0.01
    for cls in (tzd.ExpConcrete, tzd.Concrete):
        with pytest.raises(ValueError, match="scalar"):
            cls(torch.ones(2), torch.zeros(3))
        with pytest.raises(ValueError, match="at least 1-D"):
            cls(torch.tensor(1.0), torch.tensor(0.0))
    assert tzd.ExpGumbelSoftmax is tzd.ExpConcrete
    assert tzd.GumbelSoftmax is tzd.Concrete


def test_matrix_variate_normal_vs_kron_mvn_moments_and_checks():
    n, m = 3, 2
    rng = np.random.RandomState(0)
    a = rng.randn(n, n)
    u = a @ a.T + n * np.eye(n)
    b = rng.randn(m, m)
    v = b @ b.T + m * np.eye(m)
    mean, x = rng.randn(n, m), rng.randn(n, m)
    dist = tzd.MatrixVariateNormalCholesky(
        torch.tensor(mean), torch.tensor(np.linalg.cholesky(u)),
        torch.tensor(np.linalg.cholesky(v)))
    want = stats.multivariate_normal.logpdf(
        x.flatten(order="F"), mean.flatten(order="F"), np.kron(v, u))
    _close(dist.log_prob(torch.tensor(x)), want, 1e-8)
    u2 = np.array([[2.0, 0.5], [0.5, 1.0]])
    v2 = np.array([[1.5, -0.3], [-0.3, 0.8]])
    s = _np(tzd.MatrixVariateNormalCholesky(
        torch.zeros(2, 2, dtype=torch.float64),
        torch.tensor(np.linalg.cholesky(u2)),
        torch.tensor(np.linalg.cholesky(v2))).sample(_gen(), 200_000))
    exxt = np.einsum("sij,skj->ik", s, s) / s.shape[0]
    np.testing.assert_allclose(exxt, u2 * np.trace(v2), atol=0.05)
    with pytest.raises(ValueError, match="at least 2-D"):
        tzd.MatrixVariateNormalCholesky(torch.zeros(3), torch.eye(3),
                                        torch.eye(1))
    with pytest.raises(ValueError, match="u_tril trailing dims"):
        tzd.MatrixVariateNormalCholesky(torch.zeros(3, 2), torch.eye(2),
                                        torch.eye(2))
    with pytest.raises(ValueError, match="v_tril trailing dims"):
        tzd.MatrixVariateNormalCholesky(torch.zeros(3, 2), torch.eye(3),
                                        torch.eye(3))


def _student_t(df=4.5, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(3, 3)
    scale = a @ a.T + 3 * np.eye(3)
    loc = rng.randn(3)
    dist = tzd.MultivariateStudentTCholesky(
        torch.tensor(df, dtype=torch.float64), torch.tensor(loc),
        torch.tensor(np.linalg.cholesky(scale)))
    return dist, loc, scale, df


def test_student_t_vs_scipy_moments_tails_and_checks():
    dist, loc, scale, df = _student_t()
    xs = np.random.RandomState(1).randn(7, 3) * 2
    _close(dist.log_prob(torch.tensor(xs)),
           stats.multivariate_t.logpdf(xs, loc, scale, df), 1e-12)
    x = _np(dist.sample(_gen(0), 200_000))
    np.testing.assert_allclose(x.mean(0), loc, atol=0.03)
    np.testing.assert_allclose(np.cov(x.T), scale * df / (df - 2.0),
                               rtol=0.08)
    dist, loc, scale, df = _student_t(df=3.0)
    x = _np(dist.sample(_gen(1), 100_000))
    z = (x - loc) / np.sqrt(np.diag(scale) * df / (df - 2.0))
    assert ((z ** 4).mean(0) > 5.0).all()
    with pytest.raises(ValueError, match="at least 1-D"):
        tzd.MultivariateStudentTCholesky(torch.tensor(3.0),
                                         torch.tensor(0.0), torch.eye(2))
    with pytest.raises(ValueError, match="at least 2-D"):
        tzd.MultivariateStudentTCholesky(torch.tensor(3.0), torch.zeros(2),
                                         torch.ones(2))
    with pytest.raises(ValueError, match="trailing dims"):
        tzd.MultivariateStudentTCholesky(torch.tensor(3.0), torch.zeros(3),
                                         torch.eye(2))


def test_student_t_bn_sugar():
    bn = BayesianNet(key=0)
    x = bn.multivariate_student_t_cholesky(
        "x", torch.tensor(5.0, dtype=torch.float64),
        torch.zeros(2, dtype=torch.float64),
        torch.eye(2, dtype=torch.float64), n_samples=16)
    assert tuple(x.tensor.shape) == (16, 2)
    assert bool(torch.isfinite(bn.cond_log_prob("x")).all())
