"""Parity tests of zhusuan_tpu_torch's distributions (``Normal`` and
``MultivariateNormalCholesky``) against the JAX package, on the CPU in
float64.

Both packages get the same inputs from numpy; the port's samples take the
JAX package's standard normals through ``sample(eps=...)``. Values and
gradients must agree to 1e-12: the two packages evaluate the same formulas
in float64. The own-sample fast path of the multivariate Normal is covered
as in ``tests/distributions/test_own_sample_fastpath.py``, including the
zero gradient it gives the strictly upper entries of ``cov_tril``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu_torch import distributions as tdist
from zhusuan_tpu_torch.ops.checks import check_numerics

torch.set_num_threads(1)

TOL = 1e-12
KEY = jax.random.PRNGKey(11)
D = 4


def _t(x, requires_grad=False):
    return torch.tensor(np.array(x), dtype=torch.float64,
                        requires_grad=requires_grad)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _eps(key, shape):
    """The standard normals a JAX ``_sample`` draws from ``key``."""
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


# --------------------------------------------------------------------- #
# Normal
# --------------------------------------------------------------------- #
def _normal_params(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 5), rng.uniform(0.3, 2.0, (3, 5)),
            rng.randn(2, 3, 5))


@pytest.mark.parametrize("param", ["std", "logstd"])
@pytest.mark.parametrize("group_ndims", [0, 1, 2])
def test_normal_log_prob_matches_jax(param, group_ndims):
    mean, std, given = _normal_params()
    value = std if param == "std" else np.log(std)
    jd = zs.distributions.Normal(jnp.asarray(mean), group_ndims=group_ndims,
                                 **{param: jnp.asarray(value)})
    td = tdist.Normal(_t(mean), group_ndims=group_ndims,
                      **{param: _t(value)})
    assert td.batch_shape == tuple(jd.batch_shape) == (3, 5)
    assert td.value_shape == ()
    _close(td.log_prob(_t(given)), jd.log_prob(jnp.asarray(given)))
    _close(td.prob(_t(given)), jd.prob(jnp.asarray(given)))


def test_normal_broadcasts_parameters():
    rng = np.random.RandomState(1)
    mean, logstd, given = rng.randn(4, 1), rng.randn(1, 3) * 0.3, rng.randn(3)
    jd = zs.distributions.Normal(jnp.asarray(mean),
                                 logstd=jnp.asarray(logstd), group_ndims=1)
    td = tdist.Normal(_t(mean), logstd=_t(logstd), group_ndims=1)
    assert td.batch_shape == (4, 3)
    _close(td.log_prob(_t(given)), jd.log_prob(jnp.asarray(given)))


@pytest.mark.parametrize("n_samples", [None, 1, 6])
def test_normal_samples_from_injected_eps(n_samples):
    mean, std, _ = _normal_params(2)
    jd = zs.distributions.Normal(jnp.asarray(mean), std=jnp.asarray(std))
    want = jd.sample(KEY, n_samples)
    eps = _eps(KEY, (n_samples or 1, 3, 5))
    if n_samples is None:
        eps = eps[0]
    got = tdist.Normal(_t(mean), std=_t(std)).sample(n_samples=n_samples,
                                                     eps=_t(eps))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("param", ["std", "logstd"])
@pytest.mark.parametrize("path_derivative", [False, True])
def test_normal_gradients_match_jax(param, path_derivative):
    """d/d(mean, std or logstd) of sum(log_prob(own sample)), through the
    reparameterized sample and the density (STL stops the density's
    parameter path)."""
    mean, std, _ = _normal_params(3)
    value = std if param == "std" else np.log(std)
    eps = _eps(KEY, (7, 3, 5))

    def jloss(m, s):
        d = zs.distributions.Normal(m, use_path_derivative=path_derivative,
                                    **{param: s})
        return jnp.sum(d.log_prob(d.sample(KEY, 7)) * jnp.arange(5.0))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(mean),
                                           jnp.asarray(value))
    m, s = _t(mean, True), _t(value, True)
    d = tdist.Normal(m, use_path_derivative=path_derivative, **{param: s})
    loss = torch.sum(d.log_prob(d.sample(n_samples=7, eps=_t(eps)))
                     * torch.arange(5.0, dtype=torch.float64))
    got = torch.autograd.grad(loss, (m, s))
    for g, w in zip(got, want):
        _close(g, w)


def test_normal_non_reparameterized_sample_is_detached():
    m = _t(0.5, True)
    d = tdist.Normal(m, std=_t(1.0), is_reparameterized=False)
    assert not d.sample(n_samples=3, eps=_t(np.ones(3))).requires_grad


def test_normal_argument_errors_match_jax():
    for dist in (zs.distributions.Normal, tdist.Normal):
        with pytest.raises(ValueError, match="keyword arguments"):
            dist(0.0, 1.0)  # legacy positional logstd
        with pytest.raises(ValueError, match="Exactly one"):
            dist(0.0)
        with pytest.raises(ValueError, match="Exactly one"):
            dist(0.0, std=1.0, logstd=0.0)
        with pytest.raises(ValueError, match="group_ndims"):
            dist(np.zeros(3), std=1.0, group_ndims=2).log_prob(np.zeros(3))
        with pytest.raises(ValueError):
            dist(0.0, std=1.0, group_ndims=-1)
    with pytest.raises(TypeError, match="same dtype"):
        tdist.Normal(torch.zeros(2, dtype=torch.float32),
                     std=torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="broadcast"):
        tdist.Normal(torch.zeros(3), std=1.0).log_prob(torch.zeros(4))
    with pytest.raises(ValueError, match="Generator or eps"):
        tdist.Normal(0.0, std=1.0).sample()
    with pytest.raises(ValueError, match="eps must have shape"):
        tdist.Normal(torch.zeros(3), std=1.0).sample(n_samples=2,
                                                     eps=torch.zeros(3))


def test_normal_weak_scalar_dtype():
    d = tdist.Normal(torch.zeros(2, dtype=torch.float64), std=1.0)
    assert d.dtype == torch.float64
    assert tdist.Normal(0.0, std=1.0).dtype == torch.float32


def test_normal_sample_from_generator_is_reproducible():
    d = tdist.Normal(torch.zeros(3), std=2.0)
    a = d.sample(torch.Generator().manual_seed(5), 4)
    b = d.sample(torch.Generator().manual_seed(5), 4)
    assert a.shape == (4, 3) and torch.equal(a, b)


def test_check_numerics():
    x = torch.tensor([1.0, 2.0])
    assert check_numerics(x, "x") is x
    bad = torch.tensor([1.0, float("nan")])
    with pytest.raises(FloatingPointError, match="'bad'"):
        check_numerics(bad, "bad")
    assert check_numerics(bad, "bad", enabled=False) is bad
    with pytest.raises(FloatingPointError, match="precision"):
        tdist.Normal(0.0, logstd=torch.tensor(-1e4, dtype=torch.float64),
                     check_numerics=True).log_prob(0.0)


# --------------------------------------------------------------------- #
# MultivariateNormalCholesky
# --------------------------------------------------------------------- #
def _mvn_params(dtype=np.float64, batch=()):
    rng = np.random.RandomState(0)
    a = rng.randn(*batch, D, D).astype(dtype)
    diag = np.exp(np.diagonal(a, axis1=-2, axis2=-1) * 0.3) + 0.5
    tril = np.tril(a, -1) + diag[..., None] * np.eye(D)
    mean = (np.arange(D) * 0.5).astype(dtype)
    return mean, tril


def _mvns(mean, tril, **kw):
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    return (zs.distributions.MultivariateNormalCholesky(
                jnp.asarray(mean), jnp.asarray(tril), **jkw),
            tdist.MultivariateNormalCholesky(_t(mean), _t(tril), **tkw))


@pytest.mark.parametrize("path", ["solve", "cov_tril_inv"])
@pytest.mark.parametrize("batch,group_ndims", [((), 0), ((3,), 0),
                                               ((3,), 1)])
def test_mvn_log_prob_matches_jax(path, batch, group_ndims):
    mean, tril = _mvn_params(batch=batch)
    kw = {"group_ndims": group_ndims}
    if path == "cov_tril_inv":
        kw["cov_tril_inv"] = np.linalg.inv(tril)
    jd, td = _mvns(mean, tril, **kw)
    given = np.random.RandomState(4).randn(5, *batch, D)
    assert td.batch_shape == tuple(jd.batch_shape) == batch
    assert td.value_shape == (D,)
    _close(td.log_prob(_t(given)), jd.log_prob(jnp.asarray(given)))


@pytest.mark.parametrize("n_samples", [None, 7])
def test_mvn_samples_from_injected_eps(n_samples):
    mean, tril = _mvn_params(batch=(2,))
    jd, td = _mvns(mean, tril)
    want = jd.sample(KEY, n_samples)
    eps = _eps(KEY, (n_samples or 1, 2, D))
    if n_samples is None:
        eps = eps[0]
    got = td.sample(n_samples=n_samples, eps=_t(eps))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("n_samples", [None, 7])
def test_mvn_own_sample_fast_path_value(n_samples):
    """Scoring the distribution's own sample skips the solve; its value is
    the JAX package's (fast path) and the solve path's."""
    mean, tril = _mvn_params()
    jd, td = _mvns(mean, tril)
    js = jd.sample(KEY, n_samples)
    eps = _eps(KEY, (n_samples or 1, D))
    ts = td.sample(n_samples=n_samples,
                   eps=_t(eps[0] if n_samples is None else eps))
    _close(td.log_prob(ts), jd.log_prob(js))
    _close(td.log_prob(ts), td.log_prob(ts * 1.0))


def test_mvn_fast_path_is_identity_checked():
    mean, tril = _mvn_params()
    td = tdist.MultivariateNormalCholesky(_t(mean), _t(tril))
    first = td.sample(n_samples=3, eps=_t(_eps(KEY, (3, D))))
    assert td._own_sample is first
    copy = first.clone()
    td.sample(n_samples=3, eps=_t(_eps(jax.random.PRNGKey(2), (3, D))))
    # The first sample lost its fast path: the solve path scores it, and
    # agrees with a copy's score.
    _close(td.log_prob(first), td.log_prob(copy))


def _mvn_loss(lib, mean, tril, eps, mode):
    """sum(log_prob) of a 9-sample draw scored by ``mode``: "fast" (the
    sample itself), "solve" (a copy), "inv" (a copy, with cov_tril_inv)."""
    if lib == "jax":
        kw = {}
        if mode == "inv":
            kw["cov_tril_inv"] = jax.scipy.linalg.solve_triangular(
                tril, jnp.eye(D, dtype=tril.dtype), lower=True)
        d = zs.distributions.MultivariateNormalCholesky(mean, tril, **kw)
        s = d.sample(KEY, n_samples=9)
    else:
        kw = {}
        if mode == "inv":
            kw["cov_tril_inv"] = torch.linalg.solve_triangular(
                tril, torch.eye(D, dtype=tril.dtype), upper=False)
        d = tdist.MultivariateNormalCholesky(mean, tril, **kw)
        s = d.sample(n_samples=9, eps=eps)
    weights = 1.0 + 0.1 * np.arange(9)
    if lib == "torch":
        weights = _t(weights)
    return (d.log_prob(s if mode == "fast" else s * 1.0) * weights).sum()


@pytest.mark.parametrize("mode", ["fast", "solve", "inv"])
def test_mvn_gradients_match_jax(mode):
    """Gradients with respect to mean and to the full cov_tril matrix on
    each path match the JAX package's."""
    mean, tril = _mvn_params()
    eps = _t(_eps(KEY, (9, D)))
    want = jax.grad(lambda m, c: _mvn_loss("jax", m, c, None, mode),
                    argnums=(0, 1))(jnp.asarray(mean), jnp.asarray(tril))
    m, c = _t(mean, True), _t(tril, True)
    got = torch.autograd.grad(_mvn_loss("torch", m, c, eps, mode), (m, c),
                              materialize_grads=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_mvn_fast_path_zero_gradient_above_the_diagonal():
    """The fast path gives the strictly upper entries of cov_tril (which
    the density ignores) a zero gradient, where the solve path passes on a
    sampling-path term; on the lower triangle the two agree."""
    mean, tril = _mvn_params()
    eps = _t(_eps(KEY, (9, D)))
    grads = {}
    for mode in ("fast", "solve"):
        c = _t(tril, True)
        grads[mode], = torch.autograd.grad(
            _mvn_loss("torch", _t(mean), c, eps, mode), c)
    upper = np.triu(np.ones((D, D), bool), 1)
    assert (grads["fast"].numpy()[upper] == 0).all()
    assert np.abs(grads["solve"].numpy()[upper]).max() > 1e-3
    _close(grads["fast"].numpy()[~upper], grads["solve"].numpy()[~upper],
           tol=1e-10)


def test_mvn_raw_parameterization_gradients_agree_across_paths():
    """Through a raw -> tril parameterization the fast and solve paths give
    the same gradients (test_own_sample_fastpath.py:49-72)."""
    raw0 = np.random.RandomState(0).randn(D, D)
    mean0 = np.arange(D) * 0.5
    eps = _t(_eps(KEY, (9, D)))
    out = {}
    for mode in ("fast", "solve"):
        m, raw = _t(mean0, True), _t(raw0, True)
        tril = torch.tril(raw, -1) + torch.diag(
            torch.exp(torch.diagonal(raw) * 0.3) + 0.5)
        out[mode] = torch.autograd.grad(
            _mvn_loss("torch", m, tril, eps, mode), (m, raw),
            materialize_grads=True)
    for a, b in zip(out["fast"], out["solve"]):
        _close(a, b, tol=1e-10)


def test_mvn_path_derivative_gives_stl_gradients():
    """use_path_derivative takes the solve path with detached parameters,
    as in JAX (test_own_sample_fastpath.py:74-101)."""
    mean, tril = _mvn_params()
    eps = _t(_eps(KEY, (9, D)))

    def jloss(m, c):
        d = zs.distributions.MultivariateNormalCholesky(
            m, c, use_path_derivative=True)
        return jnp.sum(d.log_prob(d.sample(KEY, n_samples=9)))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(mean),
                                           jnp.asarray(tril))
    m, c = _t(mean, True), _t(tril, True)
    d = tdist.MultivariateNormalCholesky(m, c, use_path_derivative=True)
    got = torch.autograd.grad(
        torch.sum(d.log_prob(d.sample(n_samples=9, eps=eps))), (m, c))
    for g, w in zip(got, want):
        _close(g, w)
    c2 = _t(tril, True)
    plain, = torch.autograd.grad(
        _mvn_loss("torch", _t(mean), c2, eps, "fast"), c2)
    assert not np.allclose(got[1].numpy(), plain.numpy())


def test_mvn_non_reparameterized_keeps_score_gradient():
    mean, tril = _mvn_params()
    eps = _t(_eps(KEY, (9, D)))

    def jloss(m, c):
        d = zs.distributions.MultivariateNormalCholesky(
            m, c, is_reparameterized=False)
        return jnp.sum(d.log_prob(d.sample(KEY, n_samples=9)))

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(mean),
                                           jnp.asarray(tril))
    m, c = _t(mean, True), _t(tril, True)
    d = tdist.MultivariateNormalCholesky(m, c, is_reparameterized=False)
    s = d.sample(n_samples=9, eps=eps)
    assert not s.requires_grad
    got = torch.autograd.grad(torch.sum(d.log_prob(s)), (m, c))
    for g, w in zip(got, want):
        _close(g, w)


def test_mvn_argument_errors():
    for mvn in (zs.distributions.MultivariateNormalCholesky,
                tdist.MultivariateNormalCholesky):
        with pytest.raises(ValueError, match="cov_tril_inv"):
            mvn(np.zeros(4), np.eye(4), cov_tril_inv=np.eye(3))
        with pytest.raises(ValueError, match="trailing dims"):
            mvn(np.zeros(3), np.eye(4))
        with pytest.raises(ValueError, match="at least 1-D"):
            mvn(np.float64(0.0), np.eye(1))
        with pytest.raises(ValueError, match="at least 2-D"):
            mvn(np.zeros(1), np.ones(1))
    with pytest.raises(FloatingPointError, match="diag"):
        tdist.MultivariateNormalCholesky(
            _t(np.zeros(2)), _t(-np.eye(2)), check_numerics=True).log_prob(
                _t(np.zeros(2)))
