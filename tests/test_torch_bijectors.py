"""Parity tests of zhusuan_tpu_torch/bijectors.py against the JAX package's
``zhusuan_tpu/bijectors.py``, on the CPU in float64.

Both packages get the same inputs from numpy; ``forward``, ``inverse`` and
``forward_log_det`` must agree to 1e-12 (the same formulas in float64), the
round trips and the autograd log-determinants hold as in
``tests/test_bijectors.py``, and ``transform_log_joint`` gives the same
unconstrained density and maps, also through the port's HMC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu import bijectors as jbij
from zhusuan_tpu_torch import bijectors as tbij

torch.set_num_threads(1)

TOL = 1e-12


def _t(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


SCALAR = {
    "exp": (tbij.Exp, jbij.Exp, ()),
    "softplus": (tbij.Softplus, jbij.Softplus, ()),
    "sigmoid": (tbij.Sigmoid, jbij.Sigmoid, ()),
    "sigmoid_interval": (tbij.Sigmoid, jbij.Sigmoid, (-2.0, 3.0)),
}


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_bijector_matches_jax(name):
    tcls, jcls, args = SCALAR[name]
    tb, jb = tcls(*args), jcls(*args)
    y = np.concatenate([np.linspace(-4.0, 4.0, 41),
                        np.random.RandomState(0).randn(3, 5).ravel() * 3])
    x = np.asarray(jb.forward(jnp.asarray(y)))
    _close(tb.forward(_t(y)), x)
    _close(tb.inverse(_t(x)), jb.inverse(jnp.asarray(x)))
    _close(tb.forward_log_det(_t(y)), jb.forward_log_det(jnp.asarray(y)))
    assert tb.unconstrained_shape((3, 5)) == jb.unconstrained_shape((3, 5))


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_roundtrip_and_autograd_log_det(name):
    """tests/test_bijectors.py::test_roundtrip_and_log_det."""
    tcls, _, args = SCALAR[name]
    tb = tcls(*args)
    y = torch.linspace(-4.0, 4.0, 41, dtype=torch.float64,
                       requires_grad=True)
    x = tb.forward(y)
    _close(tb.inverse(x), y.detach().numpy(), 1e-8)
    (d,) = torch.autograd.grad(x.sum(), y)
    np.testing.assert_allclose(tb.forward_log_det(y).detach().numpy(),
                               torch.log(d).numpy(), rtol=1e-6, atol=1e-12)


def test_softplus_tails_match_jax():
    """logaddexp(y, 0), not a thresholded softplus: the far tails too."""
    y = np.array([-745.0, -40.0, -20.0, 19.9, 20.1, 40.0, 700.0])
    tb, jb = tbij.Softplus(), jbij.Softplus()
    _close(tb.forward(_t(y)), jb.forward(jnp.asarray(y)))
    _close(tb.forward_log_det(_t(y)), jb.forward_log_det(jnp.asarray(y)))
    x = np.array([1e-8, 1e-3, 1.0, 30.0, 500.0])
    _close(tb.inverse(_t(x)), jb.inverse(jnp.asarray(x)))


def test_sigmoid_validation():
    with pytest.raises(ValueError, match="hi > lo"):
        tbij.Sigmoid(1.0, 1.0)


VECTOR = {
    "stick_breaking": (tbij.StickBreaking, jbij.StickBreaking, (4,)),
    "stick_breaking_batch": (tbij.StickBreaking, jbij.StickBreaking,
                             (3, 2, 6)),
    "ordered": (tbij.Ordered, jbij.Ordered, (5,)),
    "ordered_batch": (tbij.Ordered, jbij.Ordered, (7, 3)),
    "correlation_cholesky": (tbij.CorrelationCholesky,
                             jbij.CorrelationCholesky, (6,)),
    "correlation_cholesky_batch": (tbij.CorrelationCholesky,
                                   jbij.CorrelationCholesky, (5, 10)),
}


@pytest.mark.parametrize("name", sorted(VECTOR))
def test_vector_bijector_matches_jax(name):
    tcls, jcls, shape = VECTOR[name]
    tb, jb = tcls(), jcls()
    y = np.random.RandomState(len(name)).randn(*shape)
    x = np.asarray(jb.forward(jnp.asarray(y)))
    got = tb.forward(_t(y))
    assert tuple(got.shape) == x.shape
    _close(got, x)
    # CorrelationCholesky.inverse divides by sqrt(1 - cumsum(x^2)): 1e-10,
    # as tests/test_bijectors.py:204 holds its round trip.
    inv_tol = 1e-10 if "cholesky" in name else TOL
    _close(tb.inverse(_t(x)), jb.inverse(jnp.asarray(x)), inv_tol)
    _close(tb.inverse(got), y, inv_tol)
    _close(tb.forward_log_det(_t(y)), jb.forward_log_det(jnp.asarray(y)))
    assert (tb.unconstrained_shape(x.shape)
            == tuple(jb.unconstrained_shape(x.shape)) == tuple(shape))


def test_stick_breaking_properties():
    """tests/test_bijectors.py::test_stick_breaking_roundtrip_and_log_det."""
    sb = tbij.StickBreaking()
    y = _t(np.random.RandomState(0).randn(4)).requires_grad_(True)
    x = sb.forward(y)
    assert abs(float(x.sum()) - 1.0) < 1e-12 and float(x.min()) > 0
    _close(sb.forward(torch.zeros(4, dtype=torch.float64)), np.full(5, 0.2),
           1e-14)
    jac = torch.autograd.functional.jacobian(lambda t: sb.forward(t)[:4], y)
    want = float(np.linalg.slogdet(jac.numpy())[1])
    np.testing.assert_allclose(float(sb.forward_log_det(y)), want, rtol=1e-10)
    assert sb.unconstrained_shape((7, 5)) == (7, 4)
    with pytest.raises(ValueError, match="simplex axis"):
        sb.unconstrained_shape((1,))


def test_ordered_properties():
    od = tbij.Ordered()
    y = _t(np.random.RandomState(1).randn(5))
    x = od.forward(y)
    assert (np.diff(x.numpy()) > 0).all()
    jac = torch.autograd.functional.jacobian(od.forward, y)
    want = float(np.linalg.slogdet(jac.numpy())[1])
    np.testing.assert_allclose(float(od.forward_log_det(y)), want, rtol=1e-10)


def test_correlation_cholesky_properties():
    cc = tbij.CorrelationCholesky()
    y = _t(np.random.RandomState(2).randn(6))  # K = 4
    L = cc.forward(y).numpy()
    corr = L @ L.T
    np.testing.assert_allclose(np.diag(corr), 1.0, atol=1e-12)
    assert np.linalg.eigvalsh(corr).min() > 0
    assert np.allclose(L, np.tril(L))
    rows, cols = np.tril_indices(4, -1)
    jac = torch.autograd.functional.jacobian(
        lambda t: cc.forward(t)[rows, cols], y)
    want = float(np.linalg.slogdet(jac.numpy())[1])
    np.testing.assert_allclose(float(cc.forward_log_det(y)), want, rtol=1e-9)
    assert cc.unconstrained_shape((4, 4)) == (6,)
    with pytest.raises(ValueError, match="K\\(K-1\\)/2"):
        cc.forward(torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="trailing \\[K, K\\]"):
        cc.unconstrained_shape((4, 3))


def test_base_class_is_abstract():
    b = tbij.Bijector()
    for method in (b.forward, b.inverse, b.forward_log_det):
        with pytest.raises(NotImplementedError):
            method(torch.zeros(2))
    assert b.unconstrained_shape([2, 3]) == (2, 3)


# --------------------------------------------------------------------- #
# transform_log_joint
# --------------------------------------------------------------------- #
def _log_joints():
    x = 0.8 * np.random.RandomState(0).randn(50)

    def jlj(obs):
        w, sigma, p = obs["w"], obs["sigma"], obs["p"]
        lp = -0.5 * w ** 2 - sigma + jnp.log(p) + 3.0 * jnp.log1p(-p)
        lp += jnp.sum(-0.5 * ((jnp.asarray(x) - w[..., None])
                              / sigma[..., None]) ** 2
                      - jnp.log(sigma)[..., None], axis=-1)
        return lp + jnp.sum(jnp.log(obs["s"]) * jnp.asarray([1.0, 2.0, 3.0]),
                            axis=-1)

    def tlj(obs):
        w, sigma, p = obs["w"], obs["sigma"], obs["p"]
        lp = -0.5 * w ** 2 - sigma + torch.log(p) + 3.0 * torch.log1p(-p)
        lp = lp + torch.sum(-0.5 * ((_t(x) - w[..., None])
                                    / sigma[..., None]) ** 2
                            - torch.log(sigma)[..., None], dim=-1)
        return lp + torch.sum(torch.log(obs["s"])
                              * _t([1.0, 2.0, 3.0]), dim=-1)

    return jlj, tlj


def test_transform_log_joint_matches_jax():
    """Scalar and vector bijectors and an untouched latent in one model:
    the same unconstrained density, gradient and maps, at 1e-12."""
    jlj, tlj = _log_joints()
    julj, jto_u, jto_c = jbij.transform_log_joint(
        jlj, {"sigma": jbij.Softplus(), "p": jbij.Sigmoid(),
              "s": jbij.StickBreaking()})
    tulj, tto_u, tto_c = tbij.transform_log_joint(
        tlj, {"sigma": tbij.Softplus(), "p": tbij.Sigmoid(),
              "s": tbij.StickBreaking()})
    rng = np.random.RandomState(5)
    cons = {"w": rng.randn(6), "sigma": rng.uniform(0.3, 2.0, 6),
            "p": rng.uniform(0.1, 0.9, 6),
            "s": rng.dirichlet(np.ones(3), 6)}
    ju = jto_u({k: jnp.asarray(v) for k, v in cons.items()})
    tu = tto_u({k: _t(v) for k, v in cons.items()})
    for k in cons:
        _close(tu[k], ju[k])
    assert tu["s"].shape == (6, 2)
    tu = {k: v.clone().requires_grad_(True) for k, v in tu.items()}
    lp = tulj(tu)
    assert lp.shape == (6,)
    _close(lp, julj(ju))
    grads = torch.autograd.grad(lp.sum(), list(tu.values()))
    jgrads = jax.grad(lambda u: jnp.sum(julj(u)))(ju)
    for k, g in zip(tu, grads):
        _close(g, jgrads[k], 1e-10)
    back = tto_c({k: v.detach() for k, v in tu.items()})
    for k in cons:
        _close(back[k], cons[k], 1e-10)


def test_transform_log_joint_accepts_a_meta_bn():
    """tests/test_bijectors.py::test_meta_bn_accepted, with the port's one
    positive-support distribution."""

    @zt.meta_bayesian_net()
    def tmodel():
        bn = zt.BayesianNet()
        bn.gamma("s", _t(2.0), _t(1.5))
        return bn

    @zs.meta_bayesian_net()
    def jmodel():
        bn = zs.BayesianNet()
        bn.gamma("s", jnp.float64(2.0), jnp.float64(1.5), n_samples=None)
        return bn

    tulj, tto_u, _ = tbij.transform_log_joint(tmodel(), {"s": tbij.Exp()})
    julj, jto_u, _ = jbij.transform_log_joint(jmodel(), {"s": jbij.Exp()})
    y = tto_u({"s": _t([0.5, 1.0])})["s"]
    _close(y, jto_u({"s": jnp.asarray([0.5, 1.0])})["s"])
    _close(tulj({"s": y}), julj({"s": jnp.asarray(y.numpy())}))


def test_constrained_hmc_recovers_a_gamma_posterior():
    """HMC over softplus^-1 coordinates (the use the module's docstring
    shows): sigma ~ Gamma(3, 2) sampled through the bijector has the
    Gamma's mean 1.5 and sd 0.866."""
    dist = zt.distributions.Gamma(_t(3.0), _t(2.0))

    def log_joint(obs):
        return dist.log_prob(obs["sigma"])

    ulj, to_u, to_c = tbij.transform_log_joint(log_joint,
                                               {"sigma": tbij.Softplus()})
    hmc = zt.HMC(step_size=0.3, n_leapfrogs=8, adapt_step_size=True)
    state = hmc.init(to_u({"sigma": torch.ones(256, dtype=torch.float64)}),
                     n_chain_dims=1)
    state, out = hmc.run(meta_bn=ulj, observed={}, state=state,
                         key=torch.Generator().manual_seed(1), n_iters=300,
                         n_adapt=150)
    sigma = to_c({"sigma": out["samples"]["sigma"][150:]})["sigma"].numpy()
    assert sigma.min() > 0
    assert abs(sigma.mean() - 1.5) < 0.05, sigma.mean()
    assert abs(sigma.std() - np.sqrt(3.0) / 2.0) < 0.05, sigma.std()
