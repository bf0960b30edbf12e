"""Parity tests of zhusuan_tpu_torch's model path (``framework``:
``BayesianNet``, ``MetaBayesianNet``, the arithmetic mixin and the context
stack) and of its ELBO (``variational``) against the JAX package, on the
CPU in float64.

The JAX package draws node ``name`` of a net with key ``key`` from
``fold_in(key, crc32(name))``; :func:`_node_eps` rebuilds those standard
normals and the port takes them through ``BayesianNet(noise=...)``. Values
and gradients must then agree to 1e-12. The ELBO cases are those of
``tests/variational/test_objectives.py:47-136``, held to the JAX package's
numbers on the same draws instead of to Monte Carlo tolerances.
"""

import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu_torch import distributions as tdist
from zhusuan_tpu_torch.framework import (
    BayesianNet,
    MetaBayesianNet,
    StochasticTensor,
    meta_bayesian_net,
)
from zhusuan_tpu_torch.framework.bn import node_seed
from zhusuan_tpu_torch.framework.utils import Context, Local, reuse_variables
from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.variational import (
    EvidenceLowerBoundObjective,
    elbo,
)

torch.set_num_threads(1)

TOL = 1e-12
KEY = jax.random.PRNGKey(1234)
P, D, N = 5, 3, 7


def _t(x, requires_grad=False):
    return torch.tensor(np.array(x), dtype=torch.float64,
                        requires_grad=requires_grad)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _node_eps(key, name, shape):
    """The standard normals the JAX package's node ``name`` draws."""
    k = jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))
    return np.asarray(jax.random.normal(k, shape, jnp.float64))


# --------------------------------------------------------------------- #
# Node randomness
# --------------------------------------------------------------------- #
def test_node_seed_depends_on_key_and_name_only():
    assert node_seed(3, "w") == node_seed(3, "w")
    assert len({node_seed(k, n) for k in (0, 1, 2**40)
                for n in ("w", "x", "")}) == 9
    assert 0 <= node_seed(2**63, "w") < 2**64


def test_draws_do_not_depend_on_node_order():
    def net(names):
        bn = BayesianNet(key=7)
        for n in names:
            bn.normal(n, torch.zeros(4), std=1.0)
        return {n: bn.outputs(n) for n in names}

    a, b = net(["u", "v"]), net(["v", "u"])
    assert torch.equal(a["u"], b["u"]) and torch.equal(a["v"], b["v"])
    assert not torch.equal(a["u"], a["v"])
    c = BayesianNet(key=8)
    c.normal("u", torch.zeros(4), std=1.0)
    assert not torch.equal(c.outputs("u"), a["u"])


# --------------------------------------------------------------------- #
# StochasticTensor and the arithmetic mixin
# --------------------------------------------------------------------- #
def test_sample_cache_and_observation():
    bn = BayesianNet(key=1)
    x = bn.normal("x", torch.zeros(3, dtype=torch.float64), std=1.0,
                  n_samples=2)
    assert isinstance(x, StochasticTensor) and not x.is_observed
    assert x.tensor is x.tensor and x.shape == (2, 3)
    assert x.cond_log_p is x.cond_log_p
    _close(x.cond_log_p, x.dist.log_prob(x.tensor))
    obs = BayesianNet(observed={"x": np.ones(3, np.float32)})
    y = obs.normal("x", torch.zeros(3, dtype=torch.float64), std=1.0)
    assert y.is_observed and y.tensor.dtype == torch.float64
    assert repr(y) == "<StochasticTensor 'x' Normal observed=True>"


def test_observation_errors_match_jax():
    for lib, zero in ((zs, jnp.zeros(3)), (zt, torch.zeros(3))):
        with pytest.raises(ValueError, match="dtype"):
            bn = lib.BayesianNet(observed={"x": np.ones(3, np.int32)})
            bn.normal("x", zero, std=1.0)
        with pytest.raises(ValueError, match="broadcast"):
            bn = lib.BayesianNet(observed={"x": np.ones(4, np.float32)})
            bn.normal("x", zero, std=1.0)


def test_arithmetic_delegates_to_the_tensor():
    bn = BayesianNet(observed={"x": _t([1.0, -2.0, 3.0])})
    x = bn.normal("x", _t(np.zeros(3)), std=1.0)
    v = x.tensor
    pairs = [(x + 1, v + 1), (1 + x, 1 + v), (x - 1, v - 1), (1 - x, 1 - v),
             (x * 2, v * 2), (2 * x, 2 * v), (x / 2, v / 2), (2 / x, 2 / v),
             (x // 2, v // 2), (7 // x, 7 // v), (x % 2, v % 2),
             (7 % x, 7 % v), (x ** 2, v ** 2), (2 ** x, 2 ** v), (-x, -v),
             (+x, +v), (abs(x), abs(v)), (x @ v, v @ v), (v @ x, v @ v),
             (x[1:], v[1:]), (x < 0, v < 0), (x <= 1, v <= 1),
             (x > 0, v > 0), (x >= 1, v >= 1), (x + x, v + v),
             (torch.sum(x), torch.sum(v)), (torch.exp(x), torch.exp(v)),
             (torch.stack([x, x]), torch.stack([v, v]))]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert len(x) == 3 and x.ndim == 1
    with pytest.raises(TypeError, match="not iterable"):
        iter(x)
    with pytest.raises(TypeError, match="bool"):
        bool(x)
    assert x == x and x != bn.normal("y", 0.0, std=1.0)


# --------------------------------------------------------------------- #
# BayesianNet
# --------------------------------------------------------------------- #
def test_duplicate_names_and_missing_key_match_jax():
    for lib in (zs, zt):
        bn = lib.BayesianNet()
        bn.normal("x", 0.0, std=1.0)
        with pytest.raises(ValueError, match="unique"):
            bn.normal("x", 0.0, std=1.0)
        with pytest.raises(ValueError, match="unique"):
            bn.deterministic("x", 1.0)
        with pytest.raises(ValueError, match="PRNG key"):
            bn.get("x").tensor
        with pytest.raises(ValueError, match="keyword arguments"):
            bn.normal("z", 0.0, 1.0)  # positional Normal misuse


def test_get_query_errors_match_jax():
    for lib in (zs, zt):
        bn = lib.BayesianNet(observed={"x": 1.0})
        bn.normal("x", 0.0, std=1.0)
        bn.deterministic("d", 2.0)
        with pytest.raises(ValueError, match="isn't a node"):
            bn.get("nope")
        with pytest.raises(ValueError, match="deterministic"):
            bn.cond_log_prob("d")
        with pytest.raises(TypeError):
            bn.get(3)
        with pytest.raises(TypeError):
            bn["x"] = 1.0
        with pytest.raises(ValueError, match="No query options"):
            bn.query("x")
        assert "x" in bn and "nope" not in bn
    with pytest.raises(ValueError, match="no stochastic nodes"):
        BayesianNet().log_joint()


def _jax_model(mean_w, x, P):
    bn = zs.BayesianNet()
    w = bn.normal("w", mean_w, std=1.0, n_samples=P, group_ndims=1)
    y_mean = bn.deterministic("y_mean", w.tensor @ x.T)
    bn.normal("y", y_mean, std=0.5, group_ndims=1)
    return bn


def _torch_model(mean_w, x, P):
    bn = BayesianNet()
    w = bn.normal("w", mean_w, std=1.0, n_samples=P, group_ndims=1)
    y_mean = bn.deterministic("y_mean", w.tensor @ x.T)
    bn.normal("y", y_mean, std=0.5, group_ndims=1)
    return bn


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(D), rng.randn(N, D), rng.randn(P, N)


def test_sampled_net_matches_jax():
    """A net with a key: the port, fed the JAX package's draws for "w",
    gives the same values, log-probs and log-joint."""
    mean_w, x, y = _inputs()
    jbn = zs.BayesianNet(observed={"y": jnp.asarray(y)}, key=KEY)
    jw = jbn.normal("w", jnp.asarray(mean_w), std=1.0, n_samples=P,
                    group_ndims=1)
    jbn.normal("y", jw.tensor @ jnp.asarray(x).T, std=0.5, group_ndims=1)
    tbn = BayesianNet(observed={"y": _t(y)},
                      noise={"w": _t(_node_eps(KEY, "w", (P, D)))})
    tw = tbn.normal("w", _t(mean_w), std=1.0, n_samples=P, group_ndims=1)
    tbn.normal("y", tw.tensor @ _t(x).T, std=0.5, group_ndims=1)
    _close(tw.tensor, jw.tensor)
    for name in ("w", "y"):
        _close(tbn.cond_log_prob(name), jbn.cond_log_prob(name))
    _close(tbn.log_joint(), jbn.log_joint())
    assert tbn.log_joint() is tbn.log_joint()


def test_meta_bn_observe_query_and_log_joint_match_jax():
    mean_w, x, y = _inputs(1)
    w = np.random.RandomState(2).randn(P, D)
    jmeta = zs.meta_bayesian_net()(_jax_model)(jnp.asarray(mean_w),
                                               jnp.asarray(x), P)
    tmeta = meta_bayesian_net()(_torch_model)(_t(mean_w), _t(x), P)
    assert isinstance(tmeta, MetaBayesianNet)
    jbn = jmeta.observe(w=jnp.asarray(w), y=jnp.asarray(y))
    tbn = tmeta.observe(w=_t(w), y=_t(y))
    assert list(tbn.nodes) == list(jbn.nodes) == ["w", "y_mean", "y"]
    assert set(tbn.observed) == {"w", "y"}
    _close(tbn.log_joint(), jbn.log_joint())
    for got, want in zip(tbn.cond_log_prob(["w", "y"]),
                         jbn.cond_log_prob(["w", "y"])):
        _close(got, want)
    _close(tbn.local_log_prob("y"), jbn.local_log_prob("y"))
    _close(tbn.outputs("y_mean"), jbn.outputs("y_mean"))
    _close(tbn["y"].tensor, jbn["y"].tensor)
    (tv, tlp), = tbn.query(["w"], outputs=True, local_log_prob=True)
    (jv, jlp), = jbn.query(["w"], outputs=True, local_log_prob=True)
    _close(tv, jv)
    _close(tlp, jlp)
    tv, tlp = tbn.query("y", outputs=True, local_log_prob=True)
    _close(tlp, jbn.cond_log_prob("y"))
    assert tbn.query("y_mean", outputs=True)[0] is tbn.get("y_mean")
    assert [n.name for n in tbn.get(["w", "y"])] == ["w", "y"]


def test_log_joint_override_matches_jax():
    mean_w, x, y = _inputs(3)
    w = np.random.RandomState(4).randn(P, D)
    jmeta = zs.meta_bayesian_net()(_jax_model)(jnp.asarray(mean_w),
                                               jnp.asarray(x), P)
    tmeta = meta_bayesian_net()(_torch_model)(_t(mean_w), _t(x), P)

    def override(bn):
        return bn.cond_log_prob("w") + 2.5 * bn.cond_log_prob("y")

    jmeta.log_joint = override
    tmeta.log_joint = override
    assert tmeta.log_joint is override
    _close(tmeta.observe(w=_t(w), y=_t(y)).log_joint(),
           jmeta.observe(w=jnp.asarray(w), y=jnp.asarray(y)).log_joint())
    tmeta.log_joint = 3.0
    with pytest.raises(TypeError, match="non-callable"):
        tmeta.observe(w=_t(w), y=_t(y)).log_joint()


def test_meta_bn_with_a_key_samples_the_unobserved_nodes():
    mean_w, x, y = _inputs(5)
    tmeta = meta_bayesian_net()(_torch_model)(_t(mean_w), _t(x), P)
    a = tmeta.observe(3, y=_t(y))
    b = tmeta.observe(3, y=_t(y))
    assert torch.equal(a.outputs("w"), b.outputs("w"))
    assert torch.equal(a.outputs("w"), BayesianNet(key=3).normal(
        "w", _t(mean_w), std=1.0, n_samples=P, group_ndims=1).tensor)
    with pytest.raises(ValueError, match="PRNG key"):
        tmeta.observe(y=_t(y))


def test_meta_bn_errors_and_decorator_forms():
    with pytest.raises(TypeError, match="BayesianNet"):
        meta_bayesian_net()(lambda: 1.0)().observe()

    @meta_bayesian_net
    def bare(mu):
        bn = BayesianNet()
        bn.normal("x", mu, std=1.0)
        return bn

    @reuse_variables("scope")
    def build():
        return 5

    assert build() == 5 and build.__name__ == "build"
    meta = bare(_t(0.0))
    assert isinstance(meta, MetaBayesianNet) and "bare" in repr(meta)
    _close(meta.observe(x=_t(1.0)).log_joint(),
           -0.5 * np.log(2 * np.pi) - 0.5)


def test_context_stack():
    with pytest.raises(RuntimeError):
        Local.get_context()
    assert Local.try_get_context() is None
    with Local(observations={"a": 1}) as outer:
        assert Local.get_context() is outer
        with Local(key=4) as inner:
            assert Local.get_context() is inner
        assert Local.get_context() is outer
        with pytest.raises(RuntimeError):
            Context.get_context()  # a subclass has its own stack
    assert Local.try_get_context() is None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with BayesianNet() as bn:
            assert BayesianNet.get_context() is bn
    assert any(issubclass(w.category, FutureWarning) for w in caught)


# --------------------------------------------------------------------- #
# The samplers take a MetaBayesianNet
# --------------------------------------------------------------------- #
STD = np.linspace(0.5, 1.5, D)


@meta_bayesian_net()
def _gaussian_model():
    bn = BayesianNet()
    bn.normal("x", _t(np.zeros(D)), std=_t(STD), group_ndims=1)
    return bn


def _gaussian_log_joint(obs):
    return tdist.Normal(_t(np.zeros(D)), std=_t(STD),
                        group_ndims=1).log_prob(obs["x"])


def test_make_log_joint_fn_takes_a_meta_bn():
    q = {"x": _t(np.random.RandomState(0).randn(4, D))}
    _close(make_log_joint_fn(_gaussian_model(), {})(q),
           make_log_joint_fn(_gaussian_log_joint, {})(q))
    with pytest.raises(TypeError, match="MetaBayesianNet"):
        make_log_joint_fn(3, {})


@pytest.mark.parametrize("sampler", ["HMC", "SGLD", "SGHMC"])
def test_samplers_take_a_meta_bn(sampler):
    """The same run with a MetaBayesianNet and with the equivalent
    log-joint callable gives the same states."""
    q0 = {"x": _t(np.random.RandomState(1).randn(8, D))}
    finals = []
    for model in (_gaussian_model(), _gaussian_log_joint):
        if sampler == "HMC":
            s = zt.HMC(step_size=0.2, n_leapfrogs=4)
            state = s.init(dict(q0), n_chain_dims=1)
            for _ in range(3):
                state, _ = s.sample(model, {}, state,
                                    key=torch.Generator().manual_seed(9))
        else:
            s = getattr(zt, sampler)(learning_rate=0.01)
            state = s.init(dict(q0), key=torch.Generator().manual_seed(9))
            state, _ = s.run(model, {}, state,
                             torch.Generator().manual_seed(9), 3,
                             collect=False)
        finals.append(state.q["x"])
    assert torch.equal(finals[0], finals[1])


# --------------------------------------------------------------------- #
# The ELBO (tests/variational/test_objectives.py:47-136)
# --------------------------------------------------------------------- #
MEAN_P, LOGSTD_P = 1.5, 0.2
N_Q = 1000


def _jax_log_joint(observed):
    return zs.distributions.Normal(jnp.float64(MEAN_P),
                                   logstd=jnp.float64(LOGSTD_P)).log_prob(
        observed["x"])


def _torch_log_joint(observed):
    return tdist.Normal(_t(MEAN_P), logstd=_t(LOGSTD_P)).log_prob(
        observed["x"])


def _jax_q(mean_q, logstd_q, n, reparam=True):
    q = zs.BayesianNet(key=KEY)
    # Python floats would make a float32 node (JAX's weak types).
    q.normal("x", jnp.asarray(mean_q, jnp.float64),
             logstd=jnp.asarray(logstd_q, jnp.float64), n_samples=n,
             is_reparameterized=reparam)
    return q


def _torch_q(mean_q, logstd_q, n, reparam=True):
    q = BayesianNet(noise={"x": _t(_node_eps(KEY, "x", (n,)))})
    q.normal("x", mean_q, logstd=logstd_q, n_samples=n,
             is_reparameterized=reparam)
    return q


def _grads(estimator, mean_q, logstd_q, reparam, n=N_Q, **kw):
    """(JAX, port) gradients of ``estimator`` ("sgvb" or "reinforce") with
    respect to (mean_q, logstd_q)."""
    def jcost(m, s):
        lb = zs.variational.elbo(_jax_log_joint, {},
                                 variational=_jax_q(m, s, n, reparam), axis=0)
        return getattr(lb, estimator)(**kw)

    want = jax.grad(jcost, argnums=(0, 1))(jnp.float64(mean_q),
                                           jnp.float64(logstd_q))
    m, s = _t(mean_q, True), _t(logstd_q, True)
    lb = elbo(_torch_log_joint, {}, variational=_torch_q(m, s, n, reparam),
              axis=0)
    got = torch.autograd.grad(getattr(lb, estimator)(**kw), (m, s))
    return got, want


def test_elbo_value_matches_jax_and_neg_kl():
    jlb = zs.variational.elbo(_jax_log_joint, {},
                              variational=_jax_q(0.8, -0.4, N_Q), axis=0)
    tlb = elbo(_torch_log_joint, {},
               variational=_torch_q(_t(0.8), _t(-0.4), N_Q), axis=0)
    assert isinstance(tlb, EvidenceLowerBoundObjective)
    _close(tlb.tensor, jlb.tensor)
    _close(tlb.sgvb(), jlb.sgvb())
    # Per-sample values with axis=None.
    _close(elbo(_torch_log_joint, {},
                variational=_torch_q(_t(0.8), _t(-0.4), 10)).tensor,
           zs.variational.elbo(_jax_log_joint, {},
                               variational=_jax_q(0.8, -0.4, 10)).tensor)
    # Against the analytic -KL(q || p), with the port's own draws.
    q = BayesianNet(key=0)
    q.normal("x", _t(0.8), logstd=_t(-0.4), n_samples=200_000)
    var_q, var_p = np.exp(-0.8), np.exp(2 * LOGSTD_P)
    kl = LOGSTD_P + 0.4 + (var_q + (0.8 - MEAN_P) ** 2) / (2 * var_p) - 0.5
    np.testing.assert_allclose(
        float(elbo(_torch_log_joint, {}, variational=q, axis=0).tensor),
        -kl, atol=1e-2)


@pytest.mark.parametrize("at", ["q", "p"])
def test_sgvb_gradients_match_jax(at):
    args = (0.8, -0.4) if at == "q" else (MEAN_P, LOGSTD_P)
    got, want = _grads("sgvb", *args, reparam=True)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("at", ["q", "p"])
def test_reinforce_gradients_match_jax(at):
    args = (0.8, -0.2) if at == "q" else (MEAN_P, LOGSTD_P)
    got, want = _grads("reinforce", *args, reparam=False)
    for g, w in zip(got, want):
        _close(g, w)
    if at == "p":
        # At p == q the learning signal is 0, so the gradient is exactly 0.
        _close(torch.stack(got), [0.0, 0.0], 1e-6)


@pytest.mark.parametrize("variance_reduction", [False, True])
def test_reinforce_without_centering_matches_jax(variance_reduction):
    got, want = _grads("reinforce", 0.8, -0.2, reparam=False,
                       variance_reduction=variance_reduction)
    for g, w in zip(got, want):
        _close(g, w)


def test_reinforce_moving_mean_and_baseline_match_jax():
    n = 100
    baseline = np.linspace(-1.0, 1.0, n)
    jlb = zs.variational.elbo(_jax_log_joint, {},
                              variational=_jax_q(0.8, -0.2, n, False), axis=0)
    tlb = elbo(_torch_log_joint, {},
               variational=_torch_q(_t(0.8), _t(-0.2), n, False), axis=0)
    jout = jlb.reinforce(moving_mean=jnp.float64(0.3), decay=0.9)
    tout = tlb.reinforce(moving_mean=_t(0.3), decay=0.9)
    assert len(tout) == 2
    for got, want in zip(tout, jout):
        _close(got, want)
    jout = jlb.reinforce(baseline=jnp.asarray(baseline),
                         moving_mean=jnp.float64(0.0), decay=0.8)
    tout = tlb.reinforce(baseline=_t(baseline), moving_mean=_t(0.0),
                         decay=0.8)
    assert len(tout) == 3
    for got, want in zip(tout, jout):
        _close(got, want)


def test_latent_interface_matches_jax():
    samples = np.random.RandomState(0).randn(5000) * 0.7 + 0.8
    jd = zs.distributions.Normal(jnp.float64(0.8), std=jnp.float64(0.7))
    td = tdist.Normal(_t(0.8), std=_t(0.7))
    jlb = zs.variational.elbo(
        _jax_log_joint, {},
        latent={"x": (jnp.asarray(samples), jd.log_prob(samples))}, axis=0)
    tlb = elbo(_torch_log_joint, {},
               latent={"x": (_t(samples), td.log_prob(_t(samples)))}, axis=0)
    _close(tlb.tensor, jlb.tensor)
    assert set(tlb.variational_inputs) == {"x"}


def test_elbo_with_a_meta_bn_model_matches_jax():
    """A MetaBayesianNet model observed at the variational samples: the
    model's ``bn`` covers every node, and the value matches the JAX
    package's."""
    def jmodel():
        bn = zs.BayesianNet()
        bn.normal("x", jnp.float64(MEAN_P), logstd=jnp.float64(LOGSTD_P))
        return bn

    def tmodel():
        bn = BayesianNet()
        bn.normal("x", _t(MEAN_P), logstd=_t(LOGSTD_P))
        bn.normal("y", bn["x"].tensor, std=1.0)
        return bn

    jlb = zs.variational.elbo(zs.meta_bayesian_net()(jmodel)(), {},
                              variational=_jax_q(0.8, -0.4, N_Q), axis=0)
    tlb = elbo(meta_bayesian_net()(tmodel)(), {"y": _t(0.3)},
               variational=_torch_q(_t(0.8), _t(-0.4), N_Q), axis=0)
    x = tlb.variational_inputs["x"]
    extra = torch.mean(tdist.Normal(x, std=1.0).log_prob(_t(0.3)))
    _close(tlb.tensor - extra, jlb.tensor)
    assert isinstance(tlb.bn, BayesianNet) and tlb.meta_bn is not None
    uncovered = elbo(meta_bayesian_net()(tmodel)(), {},
                     variational=_torch_q(_t(0.8), _t(-0.4), 3), axis=0)
    with pytest.raises(ValueError, match="neither observed nor covered"):
        uncovered.tensor


def test_objective_argument_errors():
    q = _torch_q(_t(0.0), _t(0.0), 10)
    with pytest.raises(ValueError, match="Exactly one"):
        elbo(_torch_log_joint, {}, latent={}, variational=q)
    with pytest.raises(ValueError, match="Exactly one"):
        elbo(_torch_log_joint, {})
    with pytest.raises(TypeError, match="MetaBayesianNet"):
        elbo(3, {}, variational=q)
    with pytest.raises(TypeError, match="BayesianNet"):
        elbo(_torch_log_joint, {}, variational={"x": 1})
    with pytest.raises(ValueError, match="pair"):
        elbo(_torch_log_joint, {}, latent={"x": _t(1.0)})
    with pytest.raises(ValueError, match="only available"):
        elbo(_torch_log_joint, {}, variational=q).bn
