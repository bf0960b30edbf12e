"""Parity tests of zhusuan_tpu_torch/variational/autoguide.py (the automatic
mean-field and full-rank guides) against the JAX package, on the CPU in
float64.

Both packages get the same parameters from numpy (``params_from_numpy``).
The JAX guides draw their standard normals from their key -- the mean-field
guide from ``split(key, len(names))``, one sub-key per latent in sorted-name
order (``autoguide.py:247-253``), the full-rank guide one ``[n, D]`` array
from the key itself (``:319-321``) -- and the tests rebuild those draws and
feed them to the port through ``eps=``. Samples, per-latent log-probs, the
``sgvb`` loss built on ``guide.latent`` and its gradient must then agree to
1e-12. Routing, checks and messages are held as in
``tests/variational/test_autoguide.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu.variational import FullRankGuide as JFullRank
from zhusuan_tpu.variational import MeanFieldGuide as JMeanField
from zhusuan_tpu_torch import distributions as tdist
from zhusuan_tpu_torch.variational import (
    FullRankGuide,
    MeanFieldGuide,
    autoguide,
    elbo,
    params_from_numpy,
    params_to_numpy,
)

torch.set_num_threads(1)

TOL = 1e-12
KEY = jax.random.PRNGKey(77)
F64 = jnp.float64


def _t(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------- #
# The same three models in both packages
# --------------------------------------------------------------------- #
@zs.meta_bayesian_net()
def j_unconstrained():
    bn = zs.BayesianNet()
    z = bn.normal("z", jnp.zeros(2), std=F64(1.0), group_ndims=1)
    bn.normal("x", z.tensor[..., 0] + z.tensor[..., 1], std=F64(0.5))
    return bn


@zt.meta_bayesian_net()
def t_unconstrained():
    bn = zt.BayesianNet()
    z = bn.normal("z", torch.zeros(2, dtype=torch.float64), std=_t(1.0),
                  group_ndims=1)
    bn.normal("x", z.tensor[..., 0] + z.tensor[..., 1], std=_t(0.5))
    return bn


@zs.meta_bayesian_net()
def j_constrained():
    bn = zs.BayesianNet()
    tau = bn.gamma("tau", F64(3.0), beta=F64(2.0))
    bn.normal("y", F64(0.0), std=1.0 / jnp.sqrt(tau.tensor))
    return bn


@zt.meta_bayesian_net()
def t_constrained():
    bn = zt.BayesianNet()
    tau = bn.gamma("tau", _t(3.0), _t(2.0))
    bn.normal("y", _t(0.0), std=1.0 / torch.sqrt(tau.tensor))
    return bn


@zs.meta_bayesian_net()
def j_mixed():
    """A vector, a positive scalar and a [2, 3] matrix latent."""
    bn = zs.BayesianNet()
    a = bn.normal("a", jnp.zeros(2), std=F64(1.0), group_ndims=1)
    tau = bn.gamma("tau", F64(3.0), beta=F64(2.0))
    w = bn.normal("w", jnp.zeros((2, 3)), std=F64(2.0), group_ndims=2)
    mean = jnp.sum(a.tensor, -1) + jnp.sum(w.tensor, (-1, -2))
    bn.normal("x", mean, std=1.0 / jnp.sqrt(tau.tensor))
    return bn


@zt.meta_bayesian_net()
def t_mixed():
    bn = zt.BayesianNet()
    a = bn.normal("a", torch.zeros(2, dtype=torch.float64), std=_t(1.0),
                  group_ndims=1)
    tau = bn.gamma("tau", _t(3.0), _t(2.0))
    w = bn.normal("w", torch.zeros(2, 3, dtype=torch.float64), std=_t(2.0),
                  group_ndims=2)
    mean = torch.sum(a.tensor, -1) + torch.sum(w.tensor, (-1, -2))
    bn.normal("x", mean, std=1.0 / torch.sqrt(tau.tensor))
    return bn


MODELS = {
    "unconstrained": (j_unconstrained, t_unconstrained, {"x": 1.0}),
    "constrained": (j_constrained, t_constrained, {"y": 0.3}),
    "mixed": (j_mixed, t_mixed, {"x": 0.7}),
}


def _guides(model, kind):
    jm, tm, obs = MODELS[model]
    jcls, tcls = ((JMeanField, MeanFieldGuide) if kind == "meanfield"
                  else (JFullRank, FullRankGuide))
    jg = jcls(jm(), observed={k: F64(v) for k, v in obs.items()})
    tg = tcls(tm(), observed={k: _t(v) for k, v in obs.items()})
    return jg, tg, obs


def _random_params(jg, seed):
    """Non-trivial parameters of the JAX guide's structure, as numpy."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: 0.5 * rng.randn(*v.shape), jg.init_params())


def _meanfield_eps(jg, key, n):
    """The normals ``MeanFieldGuide.sample`` draws (autoguide.py:247-253)."""
    lead = () if n is None else (n,)
    keys = jax.random.split(key, len(jg.latent_names))
    return {name: np.asarray(jax.random.normal(
        k, lead + jg._shapes[name], jg._dtypes[name]))
        for name, k in zip(jg.latent_names, keys)}


def _fullrank_eps(jg, key, n):
    """The normals ``FullRankGuide.sample`` draws (autoguide.py:319-321)."""
    lead = () if n is None else (n,)
    return np.asarray(jax.random.normal(key, lead + (jg._dim,), jg._dtype))


def _eps(jg, kind, key, n):
    return (_meanfield_eps if kind == "meanfield" else _fullrank_eps)(
        jg, key, n)


# --------------------------------------------------------------------- #
# Shapes, routing, init
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_metadata_and_init_match_jax(model, kind):
    jg, tg, _ = _guides(model, kind)
    assert tg.latent_names == jg.latent_names == sorted(jg.latent_names)
    assert tg._shapes == jg._shapes and tg._dim == jg._dim
    assert tg._dtype == torch.float64
    assert tg.device == torch.device("cpu")
    for name in tg.latent_names:
        assert (type(tg.bijectors[name]).__name__
                == type(jg.bijectors[name]).__name__)
    jp, tp = jg.init_params(), params_to_numpy(tg.init_params())
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(tp))
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp)):
        assert a.dtype == np.float64
        _close(a, b)


def test_gamma_routes_to_softplus():
    _, tg, _ = _guides("constrained", "meanfield")
    assert type(tg.bijectors["tau"]).__name__ == "Softplus"
    _, tg, _ = _guides("mixed", "meanfield")
    assert [type(tg.bijectors[n]).__name__ for n in ("a", "tau", "w")] == [
        "_Identity", "Softplus", "_Identity"]


class _Fake(tdist.Distribution):
    """A continuous distribution of a given class name and value."""

    def __init__(self, value, dtype=torch.float64):
        self._value = value
        super().__init__(dtype=dtype, param_dtype=torch.float64,
                         is_continuous=dtype.is_floating_point,
                         is_reparameterized=False)

    def _batch_shape(self):
        return tuple(self._value.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        return self._value.to(self.dtype)

    def _log_prob(self, given):
        return torch.zeros_like(given, dtype=torch.float64)


def _fake_model(name, value, monkeypatch, **attrs):
    """A one-latent model whose distribution is an instance of a class
    registered in the distributions module under ``name``: the classes the
    port does not have yet are looked up by name, so this is how they will
    route once ported."""
    cls = type(name, (_Fake,), {})
    monkeypatch.setattr(tdist, name, cls, raising=False)
    dist = cls(value)
    for k, v in attrs.items():
        setattr(dist, k, v)

    @zt.meta_bayesian_net()
    def model():
        bn = zt.BayesianNet()
        bn.stochastic("v", dist)
        return bn

    return model()


@pytest.mark.parametrize("name,bijector,value,shape", [
    ("HalfCauchy", "Softplus", torch.ones(3), (3,)),
    ("LogNormal", "Softplus", torch.ones(()), ()),
    ("Exponential", "Softplus", torch.ones(2, 2), (2, 2)),
    ("InverseGamma", "Softplus", torch.ones(3), (3,)),
    ("FoldNormal", "Softplus", torch.ones(3), (3,)),
    ("Beta", "Sigmoid", torch.full((3,), 0.5), (3,)),
    ("BinConcrete", "Sigmoid", torch.full((3,), 0.5), (3,)),
    ("Dirichlet", "StickBreaking", torch.full((4, 3), 1 / 3.0), (4, 2)),
    ("LKJCholesky", "CorrelationCholesky", torch.eye(3), (3,)),
    ("Laplace", "_Identity", torch.zeros(3), (3,)),
])
def test_default_bijector_by_class_name(name, bijector, value, shape,
                                        monkeypatch):
    g = MeanFieldGuide(_fake_model(name, value.double(), monkeypatch))
    assert type(g.bijectors["v"]).__name__ == bijector
    assert tuple(g.init_params()["loc"]["v"].shape) == shape


def test_uniform_routes_to_a_scaled_sigmoid(monkeypatch):
    m = _fake_model("Uniform", torch.zeros(3).double(), monkeypatch,
                    minval=_t(-2.0), maxval=_t(3.0))
    b = MeanFieldGuide(m).bijectors["v"]
    assert type(b).__name__ == "Sigmoid" and (b._lo, b._hi) == (-2.0, 3.0)
    m = _fake_model("Uniform", torch.zeros(3).double(), monkeypatch,
                    minval=_t([-2.0, 0.0, 0.0]), maxval=_t(3.0))
    with pytest.raises(ValueError, match="non-scalar bounds"):
        MeanFieldGuide(m)


def test_pd_matrix_support_raises(monkeypatch):
    with pytest.raises(ValueError, match="PD-matrix"):
        MeanFieldGuide(_fake_model("Wishart", torch.eye(2).double(),
                                   monkeypatch))


def test_discrete_latent_raises():
    @zt.meta_bayesian_net()
    def m():
        bn = zt.BayesianNet()
        b = bn.stochastic("b", _Fake(torch.zeros(()), torch.int32))
        bn.normal("x", b.tensor.double(), std=_t(1.0))
        return bn

    with pytest.raises(ValueError, match="discrete"):
        MeanFieldGuide(m(), observed={"x": _t(0.0)})


def test_no_free_latents_raises():
    with pytest.raises(ValueError, match="no free latents"):
        MeanFieldGuide(t_unconstrained(),
                       observed={"x": _t(0.0), "z": torch.zeros(2).double()})
    dens = zt.DiagonalGaussianLogJoint("z", torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="no free latents"):
        MeanFieldGuide(dens, observed={"z": torch.zeros(3)}, device="cpu")


def test_model_type_and_init_scale_are_checked():
    with pytest.raises(TypeError, match="MetaBayesianNet"):
        MeanFieldGuide(t_unconstrained)  # the factory, not called
    for cls in (MeanFieldGuide, FullRankGuide):
        with pytest.raises(ValueError, match="init_scale must be positive"):
            cls(t_unconstrained(), observed={"x": _t(0.0)}, init_scale=0.0)


def test_bijector_override():
    g = MeanFieldGuide(t_constrained(), observed={"y": _t(0.0)},
                       bijectors={"tau": zt.bijectors.Exp()})
    assert type(g.bijectors["tau"]).__name__ == "Exp"
    samples, _ = g.sample(g.init_params(), (1, 2), n_samples=8)
    assert (samples["tau"] > 0).all()


@pytest.mark.parametrize("cls", [MeanFieldGuide, FullRankGuide])
def test_builtin_density_guide(cls):
    """One latent, the density's name, [dim], float32, identity, no probe."""
    dens = zt.EquicorrelatedGaussianLogJoint("q", 5, 0.3)
    g = cls(dens, device="cpu")
    assert g.latent_names == ["q"] and g._shapes == {"q": (5,)}
    assert g._dtype == torch.float32 and g._dim == 5
    assert type(g.bijectors["q"]).__name__ == "_Identity"
    samples, lq = g.sample(g.init_params(), (3, 4), n_samples=6)
    assert samples["q"].shape == (6, 5) and lq["q"].shape == (6,)
    assert samples["q"].dtype == torch.float32
    lat = g.latent(g.init_params(), (3, 4), n_samples=6)
    loss = elbo(dens, {}, latent=lat, axis=0).sgvb()
    assert torch.isfinite(loss)
    assert cls(dens).device == torch.device("cuda", 0)  # the default


# --------------------------------------------------------------------- #
# sample / latent / sample_posterior on the JAX draws
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [None, 1, 64])
@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sample_matches_jax_on_its_draws(model, kind, n):
    jg, tg, _ = _guides(model, kind)
    params = _random_params(jg, 3)
    tparams = params_from_numpy(tg, params)
    eps = _eps(jg, kind, KEY, n)
    j_samples, j_lq = jg.sample(
        jax.tree_util.tree_map(jnp.asarray, params), KEY, n_samples=n)
    t_samples, t_lq = tg.sample(tparams, None, n_samples=n, eps=eps)
    lead = () if n is None else (n,)
    for name in jg.latent_names:
        assert tuple(t_lq[name].shape) == lead
        _close(t_samples[name], j_samples[name])
        _close(t_lq[name], j_lq[name], 1e-11)
    lat = tg.latent(tparams, None, n_samples=n, eps=eps)
    post = tg.sample_posterior(tparams, None, n_samples=n, eps=eps)
    for name in jg.latent_names:
        assert torch.equal(lat[name][0], t_samples[name])
        assert torch.equal(lat[name][1], t_lq[name])
        assert torch.equal(post[name], t_samples[name])


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_sgvb_loss_and_gradient_match_jax(model, kind):
    """The slice's inner step: guide.latent -> elbo(...).sgvb() ->
    gradient of the guide's parameters."""
    jm, tm, _ = MODELS[model]
    jg, tg, obs = _guides(model, kind)
    params = _random_params(jg, 5)
    n = 16
    eps = _eps(jg, kind, KEY, n)
    jobs = {k: F64(v) for k, v in obs.items()}

    def jloss(p):
        lat = jg.latent(p, KEY, n_samples=n)
        return zs.variational.elbo(jm(), jobs, latent=lat, axis=0).sgvb()

    jval, jgrad = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tparams = params_from_numpy(tg, params)
    leaves = []
    for sub in tparams.values():
        leaves += list(sub.values()) if isinstance(sub, dict) else [sub]
    for v in leaves:
        v.requires_grad_(True)
    lat = tg.latent(tparams, None, n_samples=n, eps=eps)
    loss = elbo(tm(), {k: _t(v) for k, v in obs.items()}, latent=lat,
                axis=0).sgvb()
    loss.backward()
    _close(loss, jval, 1e-11)
    tgrad = jax.tree_util.tree_map(lambda v: v.grad.numpy(), tparams)
    for a, b in zip(jax.tree_util.tree_leaves(tgrad),
                    jax.tree_util.tree_leaves(jgrad)):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fullrank_conditionals_sum_to_joint(model):
    """tests/variational/test_autoguide.py:64-102: the per-name
    autoregressive conditionals sum to the joint MVN log density (identity
    part; a bijected latent adds its -log|det J|)."""
    from scipy.stats import multivariate_normal

    jg, tg, _ = _guides(model, "fullrank")
    params = _random_params(jg, 7)
    tparams = params_from_numpy(tg, params)
    eps = _fullrank_eps(jg, KEY, 32)
    samples, lq = tg.sample(tparams, None, n_samples=32, eps=eps)
    total = sum(lq[n] for n in tg.latent_names).numpy()
    L, _ = tg._chol(tparams)
    flat = params["loc"] + eps @ L.numpy().T
    ref = multivariate_normal.logpdf(flat, params["loc"],
                                     tg.covariance(tparams).numpy())
    for name in tg.latent_names:
        b = tg.bijectors[name]
        if type(b).__name__ != "_Identity":
            s, e = tg._starts[name], tg._starts[name] + tg._sizes[name]
            ref = ref - b.forward_log_det(_t(flat[:, s:e])).sum(-1).numpy()
    _close(total, ref, 1e-10)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_median_and_covariance_match_jax(model):
    for kind in ("meanfield", "fullrank"):
        jg, tg, _ = _guides(model, kind)
        params = _random_params(jg, 9)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        tparams = params_from_numpy(tg, params)
        jmed, tmed = jg.median(jparams), tg.median(tparams)
        for name in jg.latent_names:
            _close(tmed[name], jmed[name])
    cov = tg.covariance(tparams)
    _close(cov, jg.covariance(jparams))
    assert np.linalg.eigvalsh(cov.numpy()).min() > 0


# --------------------------------------------------------------------- #
# Own draws, eps checks, parameter transfer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_own_draws_are_keyed(kind):
    _, tg, _ = _guides("mixed", kind)
    p = tg.init_params()
    a, _ = tg.sample(p, (1, 2), n_samples=5)
    b, _ = tg.sample(p, (1, 2), n_samples=5)
    c, _ = tg.sample(p, (1, 3), n_samples=5)
    d, _ = tg.sample(p, torch.Generator().manual_seed(4), n_samples=5)
    for name in tg.latent_names:
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
        assert d[name].shape == a[name].shape
    assert (a["tau"] > 0).all()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        tg.sample(p, None, n_samples=5)


def test_own_draws_have_the_guides_moments():
    _, tg, _ = _guides("unconstrained", "meanfield")
    p = tg.init_params()
    p["loc"]["z"] = _t([0.3, -0.7])
    p["log_scale"]["z"] = _t([-0.2, 0.4])
    draws = tg.sample_posterior(p, (5, 6), 20000)["z"].numpy()
    np.testing.assert_allclose(draws.mean(0), [0.3, -0.7], atol=0.04)
    np.testing.assert_allclose(draws.std(0), np.exp([-0.2, 0.4]), rtol=0.03)


def test_eps_shapes_are_checked():
    _, mf, _ = _guides("mixed", "meanfield")
    eps = {n: np.zeros((4,) + mf._shapes[n]) for n in mf.latent_names}
    eps["w"] = np.zeros((4, 3, 2))
    with pytest.raises(ValueError, match="eps\\['w'\\] must have shape"):
        mf.sample(mf.init_params(), None, n_samples=4, eps=eps)
    _, fr, _ = _guides("mixed", "fullrank")
    with pytest.raises(ValueError, match="eps must have shape"):
        fr.sample(fr.init_params(), None, n_samples=4, eps=np.zeros((4, 8)))


@pytest.mark.parametrize("kind", ["meanfield", "fullrank"])
def test_params_round_trip(kind):
    jg, tg, _ = _guides("mixed", kind)
    params = _random_params(jg, 11)
    tparams = params_from_numpy(tg, params)
    back = params_to_numpy(tparams)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    # JAX arrays go in as they are; dtype= casts every leaf.
    as_jax = jax.tree_util.tree_map(jnp.asarray, params)
    f32 = params_from_numpy(tg, as_jax, dtype=torch.float32)
    leaf = f32["loc"]["a"] if kind == "meanfield" else f32["loc"]
    assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
    with pytest.raises(ValueError, match="params has keys"):
        params_from_numpy(tg, {"loc": params["loc"]})
    if kind == "meanfield":
        bad = {k: {n: v for n, v in sub.items() if n != "tau"}
               for k, sub in params.items()}
        with pytest.raises(ValueError, match="the guide's latents"):
            params_from_numpy(tg, bad)


def test_flat_order_is_sorted_names():
    """The flat vector of the full-rank guide and of advi()'s ``noise=`` is
    sorted-name blocks, the same in both packages."""
    jg, tg, _ = _guides("mixed", "fullrank")
    assert tg._starts == jg._starts == {"a": 0, "tau": 2, "w": 3}
    _, mf, _ = _guides("mixed", "meanfield")
    flat = torch.arange(2 * 9, dtype=torch.float64).reshape(2, 9)
    parts = mf._split(flat, (2,))
    assert parts["a"].shape == (2, 2) and parts["w"].shape == (2, 2, 3)
    assert torch.equal(parts["tau"], flat[:, 2])
    assert autoguide._HALF_LOG_2PI == pytest.approx(0.9189385332046727)
