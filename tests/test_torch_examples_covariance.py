"""Parity tests of the port's covariance built-in
(``zhusuan_tpu_torch/ops/densities.py::CovarianceEstimationLogJoint``) and
of ``examples/hierarchical/covariance_estimation.py`` against the JAX
package, on the CPU.

- The built-in's value and gradient against the JAX example's
  ``transform_log_joint(build_log_joint(x), {"s": Softplus(), "L":
  CorrelationCholesky()})[0]`` in float64 at K = 3 and K = 4, over 64
  points with ``|y| <= 5`` (the partial correlations' coordinates) and
  ``u`` in [-2, 2] (the scales' coordinates):
  - where the correlation matrix is well conditioned (``|y| <= 2.5``): the
    value at 1e-12, the gradient within 1e-12 of each row's largest entry
    (its entries span eight orders of magnitude, and a small one is the
    difference of large terms);
  - up to ``|y| = 5``, where ``1 - z^2`` reaches 2e-4 and the correlation
    matrix's condition number 1e8: against a 50-digit evaluation of the
    model's definition (mpmath; the LKJ column loop, the solve, the
    Jacobians) at 1e-12 of each row's largest value, and against the JAX
    closure at 1e-11, the closure's own error there (up to 2.1e-12 of the
    value against the 50-digit one, which this test checks too).

  The JAX side passes ``eta`` as ``jnp.float64`` (a Python float makes the
  JAX ``LKJCholesky`` float32, and its ``log_prob`` casts ``L`` to float32)
  and takes the gradient in forward mode (``jax.jacfwd``): reverse mode is
  NaN at most points at K >= 4 (the ``where`` over ``sqrt(max(w^2 - L^2,
  0))`` in ``lkj.py``'s column loop, whose unselected branch is at 0 on
  the diagonal).
- Saturated ``tanh``: where a partial correlation rounds to +-1 (float64
  ``|y| >= 20``, float32 ``|y| >= 10``) the closure is not finite and the
  built-in scores ``-inf`` with a zero gradient; elsewhere both are finite.
- 30 chained adaptive NUTS iterations of the example (depth 6, step 0.1)
  from JAX's state on JAX's draws (``tests/test_torch_nuts.py::
  _jax_draws``): 1e-8.
- The kernel's gate and limits; the example's closure and maps against
  JAX's at 1e-12; ``run`` end to end on the CPU on the JAX example's data.
"""

import math

import jax
import jax.numpy as jnp
import mpmath as mp
import numpy as np
import pytest
import torch

from examples.hierarchical import covariance_estimation as jce
from zhusuan_tpu.bijectors import CorrelationCholesky as JCorrelationCholesky
from zhusuan_tpu.bijectors import Softplus as JSoftplus
from zhusuan_tpu.bijectors import transform_log_joint as jtransform
from zhusuan_tpu.distributions import LKJCholesky as JLKJCholesky
from zhusuan_tpu.mcmc.nuts import NUTS as JNUTS
from zhusuan_tpu_torch.examples.hierarchical import (
    covariance_estimation as tce,
)
from zhusuan_tpu_torch.mcmc.hmc import state_from_numpy
from zhusuan_tpu_torch.mcmc.nuts import NUTS as TNUTS
from zhusuan_tpu_torch.mcmc.nuts import nuts_transition, value_and_grad
from zhusuan_tpu_torch.ops.densities import CovarianceEstimationLogJoint
from zhusuan_tpu_torch.ops.nuts_step import DENSITIES, fused_nuts_transition
from tests.test_torch_nuts import _jax_draws

torch.set_num_threads(1)

TOL = 1e-12
TOL_CHAIN = 1e-8
RNG_DATA = {3: 0, 4: 1}


@pytest.fixture
def jax_float64_eta(monkeypatch):
    """The JAX example's ``LKJCholesky(k, 2.0)`` with a float64 ``eta``."""
    monkeypatch.setattr(jce, "LKJCholesky",
                        lambda d, eta: JLKJCholesky(d, jnp.float64(eta)))


def _data(k, n=300):
    rng = np.random.RandomState(RNG_DATA[k])
    a = rng.randn(k, k)
    return rng.randn(n, k) @ np.linalg.cholesky(a @ a.T + np.eye(k)).T


def _jax_closure(x):
    ulj, _, _ = jtransform(jce.build_log_joint(x),
                           {"s": JSoftplus(), "L": JCorrelationCholesky()})
    m = x.shape[1] * (x.shape[1] - 1) // 2

    def f(v):
        return ulj({"L": v[..., :m], "s": v[..., m:]})

    return f


def _points(k, y_max, n=64, seed=0):
    rng = np.random.RandomState(seed + 10 * k)
    m = k * (k - 1) // 2
    return np.concatenate([rng.uniform(-y_max, y_max, (n, m)),
                           rng.uniform(-2.0, 2.0, (n, k))], -1)


def _scatter(x):
    """``sum_i x_i x_i^T`` in mpmath's working precision (exact: the
    products of two doubles and their sums fit in 50 digits)."""
    n, k = x.shape
    return mp.matrix([[mp.fsum(mp.mpf(float(x[r, a])) * mp.mpf(
        float(x[r, b])) for r in range(n)) for b in range(k)]
        for a in range(k)])


def _exact(S, n, v):
    """The model's log-density at ``v`` in mpmath's working precision (50
    digits in the callers), from its definition: the JAX LKJ's column loop
    on the factor, the likelihood through ``S = sum_i x_i x_i^T`` (an
    identity), the two Jacobians."""
    k = S.rows
    m = k * (k - 1) // 2
    y = [mp.mpf(t) for t in v[:m]]
    u = [mp.mpf(t) for t in v[m:]]
    s = [mp.log(1 + mp.exp(t)) for t in u]
    pairs = [(i, j) for i in range(k) for j in range(i)]
    z = {p: mp.tanh(t) for p, t in zip(pairs, y)}
    L = mp.zeros(k, k)
    for i in range(k):
        rem = mp.mpf(1)
        for j in range(i):
            L[i, j] = z[i, j] * mp.sqrt(rem)
            rem -= L[i, j] ** 2
        L[i, i] = mp.sqrt(rem)
    lp = mp.mpf(0)
    for a in range(k):
        lp += -s[a] ** 2 / 2 - mp.log(1 + mp.exp(-u[a])) - n * mp.log(
            s[a])
    for j in range(k - 1):
        a = mp.mpf(2) + mp.mpf(k - 2 - j) / 2
        for i in range(j + 1, k):
            w = mp.sqrt(1 - sum(L[i, q] ** 2 for q in range(j)))
            c = L[i, j] / w
            lp += ((a - 1) * mp.log(1 - c * c) - (2 * a - 1) * mp.log(2)
                   - 2 * mp.loggamma(a) + mp.loggamma(2 * a) - mp.log(w))
    for (i, j) in pairs:
        pref = sum(mp.log(1 - z[i, q] ** 2) for q in range(j))
        lp += mp.log(1 - z[i, j] ** 2) + pref / 2
    D = mp.diag([1 / t for t in s])
    W = L ** -1
    Q = W * D * S * D * W.T
    lp += -sum(Q[i, i] for i in range(k)) / 2
    lp += -n * sum(mp.log(L[i, i]) for i in range(k))
    return lp


def _exact_value_and_grad(x, v):
    g = []
    with mp.workdps(50):
        S, n = _scatter(x), x.shape[0]
        lp = _exact(S, n, v)
        for e in range(len(v)):
            def f(t, e=e):
                w = [mp.mpf(float(c)) for c in v]
                w[e] = t
                return _exact(S, n, w)

            g.append(float(mp.diff(f, mp.mpf(float(v[e])))))
    return float(lp), np.array(g)


@pytest.mark.parametrize("k", [3, 4])
def test_builtin_matches_closure_well_conditioned(k, jax_float64_eta):
    x = _data(k)
    pts = _points(k, 2.5)
    f = _jax_closure(x)
    want = np.asarray(jax.vmap(f)(jnp.asarray(pts)))
    gwant = np.asarray(jax.vmap(jax.jacfwd(f))(jnp.asarray(pts)))
    dens = CovarianceEstimationLogJoint(x)
    lp, g = dens.value_and_grad(torch.tensor(pts))
    np.testing.assert_allclose(lp.numpy(), want, rtol=TOL, atol=TOL)
    scale = np.abs(gwant).max(-1, keepdims=True)
    assert (np.abs(g.numpy() - gwant) <= TOL * scale).all()
    # log_prob's backward is the written-out gradient.
    xt = torch.tensor(pts, requires_grad=True)
    dens.log_prob(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), g.numpy())


@pytest.mark.parametrize("k", [3, 4])
def test_builtin_up_to_y5_against_closure_and_50_digits(k, jax_float64_eta):
    x = _data(k)
    pts = _points(k, 5.0)
    f = _jax_closure(x)
    want = np.asarray(jax.vmap(f)(jnp.asarray(pts)))
    gwant = np.asarray(jax.vmap(jax.jacfwd(f))(jnp.asarray(pts)))
    lp, g = CovarianceEstimationLogJoint(x).value_and_grad(torch.tensor(pts))
    lp, g = lp.numpy(), g.numpy()
    assert np.isfinite(want).all() and np.isfinite(gwant).all()
    np.testing.assert_allclose(lp, want, rtol=1e-11)
    scale = np.abs(gwant).max(-1, keepdims=True)
    assert (np.abs(g - gwant) <= 1e-11 * scale).all()
    worst_jax = 0.0
    for i in range(0, 64, 8):
        e_lp, e_g = _exact_value_and_grad(x, pts[i])
        assert abs(lp[i] - e_lp) <= TOL * abs(e_lp), i
        assert (np.abs(g[i] - e_g) <= TOL * np.abs(e_g).max()).all(), i
        worst_jax = max(worst_jax, abs(want[i] - e_lp) / abs(e_lp))
    assert worst_jax < 1e-11


@pytest.mark.parametrize("dtype,big", [(np.float64, (20.0, -25.0, 40.0)),
                                       (np.float32, (10.0, -12.0, 20.0))])
def test_saturated_tanh_classified_as_the_closure(dtype, big):
    k = 3
    x = _data(k).astype(dtype)
    pts = _points(k, 2.0, n=12).astype(dtype)
    for r, b in enumerate(big):
        pts[3 * r, r] = b
        pts[3 * r + 1, (r + 1) % 3] = b
        pts[3 * r + 1, (r + 2) % 3] = -b
    f = _jax_closure(x)
    want = np.asarray(jax.vmap(f)(jnp.asarray(pts)))
    assert want.dtype == dtype
    lp, g = CovarianceEstimationLogJoint(x).value_and_grad(torch.tensor(pts))
    lp = lp.numpy()
    np.testing.assert_array_equal(np.isfinite(lp), np.isfinite(want))
    bad = ~np.isfinite(want)
    assert bad.sum() == 6
    assert (lp[bad] == -np.inf).all() and (g.numpy()[bad] == 0).all()


def test_thirty_chained_nuts_iterations_match_jax(jax_float64_eta):
    x = _data(3)
    f = _jax_closure(x)
    dens, to_u, _ = tce.covariance_density(x)
    ulj, jto_u, _ = jtransform(
        jce.build_log_joint(x), {"s": JSoftplus(), "L":
                                 JCorrelationCholesky()})
    c, depth = 6, 6
    init = tce.init_state(c, 3, "cpu", torch.float64)
    q = {k: v.numpy() for k, v in to_u(init).items()}
    kw = dict(step_size=0.1, max_tree_depth=depth, adapt_step_size=True)
    jnuts, tnuts = JNUTS(**kw), TNUTS(**kw)
    jst = jnuts.init({k: jnp.asarray(v) for k, v in q.items()},
                     n_chain_dims=1)
    step_fn = jax.jit(lambda s, kk: jnuts.sample(ulj, {}, s, kk))
    depths = []
    for i in range(30):
        key = jax.random.PRNGKey(400 + i)
        tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
        jst, info = step_fn(jst, key)
        tst, tinfo = tnuts.sample(dens, {}, tst,
                                  noise=_jax_draws(key, c, dens.dim, depth))
        np.testing.assert_allclose(tinfo.log_prob.numpy(),
                                   np.asarray(info.log_prob), rtol=TOL_CHAIN,
                                   atol=TOL_CHAIN)
        assert np.array_equal(tinfo.depth.numpy(), np.asarray(info.depth))
        assert np.array_equal(tinfo.divergent.numpy(),
                              np.asarray(info.divergent))
        for name in q:
            np.testing.assert_allclose(tst.q[name].numpy(),
                                       np.asarray(jst.q[name]),
                                       rtol=TOL_CHAIN, atol=TOL_CHAIN)
        np.testing.assert_allclose(float(tst.step_size),
                                   float(jst.step_size), rtol=TOL_CHAIN)
        depths.append(float(np.asarray(info.depth).mean()))
    assert max(depths) > 1
    del f


def test_gate_and_limits():
    dens = CovarianceEstimationLogJoint(_data(3))
    assert isinstance(dens, DENSITIES)
    assert dens.names == ("L", "s") and dens.dim == 6 and dens.n_rows == 1
    assert dens.kernel_ineligible() is None
    big = CovarianceEstimationLogJoint(np.random.RandomState(0).randn(20, 6))
    assert "K <= 5" in big.kernel_ineligible()
    with pytest.raises(ValueError, match=r"\[n, K\]"):
        CovarianceEstimationLogJoint(np.zeros((4, 1)))
    # The wrapper on CPU tensors is the plain transition on the built-in.
    q = torch.tensor(_points(3, 1.0, n=5), dtype=torch.float32)
    ones = torch.ones(1, 6)
    noise = _jax_draws(jax.random.PRNGKey(1), 5, 6, 4)
    noise = tuple(v.float() for v in noise)
    got = fused_nuts_transition(dens, q, ones, 0.05, 4, 1000.0, (1, 2), 1,
                                noise=noise)
    want = nuts_transition(value_and_grad(dens.log_prob), q, ones[0], 0.05,
                           4, 1000.0, noise)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # NUTS's gate takes the built-in (auto on CPU tensors: plain path).
    nuts = TNUTS(step_size=0.1, max_tree_depth=6)
    st = nuts.init(tce.covariance_density(_data(3))[1](
        tce.init_state(4, 3)), n_chain_dims=1)
    assert nuts._fused_ineligible(dens, {}, st.q, st.mass, 1) is None


def test_example_closure_and_maps_match_jax(jax_float64_eta):
    x = _data(3, n=50)
    rng = np.random.RandomState(5)
    L = np.asarray(JCorrelationCholesky().forward(jnp.asarray(
        rng.randn(7, 3))))
    s = 0.5 + rng.rand(7, 3)
    want = jce.build_log_joint(x)({"s": jnp.asarray(s), "L": jnp.asarray(L)})
    got = tce.build_log_joint(x, dtype=torch.float64)(
        {"s": torch.tensor(s), "L": torch.tensor(L)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _, to_u, to_c = tce.covariance_density(x)
    _, jto_u, jto_c = jtransform(jce.build_log_joint(x), {
        "s": JSoftplus(), "L": JCorrelationCholesky()})
    u = to_u({"s": torch.tensor(s), "L": torch.tensor(L)})
    ju = jto_u({"s": jnp.asarray(s), "L": jnp.asarray(L)})
    for k in ("s", "L"):
        np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to_c(u)[k].numpy(),
                                   np.asarray(jto_c(ju)[k]), rtol=TOL,
                                   atol=TOL)


def test_run_on_the_jax_data():
    x, synthetic = jce.make_data(60, jax.random.PRNGKey(2))
    res = tce.run(n=60, n_chains=4, n_iters=60, burnin=30, data=x,
                  device="cpu")
    assert res["synthetic"] and synthetic
    np.testing.assert_allclose(res["sample_cov"], np.cov(np.asarray(
        np.asarray(x, np.float32), np.float64).T, bias=True), rtol=1e-12)
    for key in ("scale_mean", "corr_mean", "cov_mean", "cov_sd"):
        assert np.isfinite(res[key]).all()
    np.testing.assert_allclose(np.diagonal(res["corr_mean"]), 1.0,
                               atol=1e-6)
    assert 0.0 <= res["divergent"] <= 1.0
    xs, synth = tce.make_data(20, seed=3)
    assert xs.shape == (20, 3) and xs.dtype == np.float32 and synth
    np.testing.assert_array_equal(xs, tce.make_data(20, seed=3)[0])
    assert math.isfinite(float(CovarianceEstimationLogJoint(xs).log_prob(
        torch.zeros(6))))
