"""The HMC kernel's (K1) routes through the built-ins it alone evaluates,
against the JAX package on the CPU in float64: ``WhitenedLogJoint``
(``whiten_log_joint`` of a built-in Gaussian), ``NealFunnelLogJoint`` and
``NeuTraLogJoint`` (``neutra_log_joint`` of the funnel, the JAX flow's
parameters carried across as numpy), ``GaussianLinearRegressionLogJoint``
(``loo_compare``'s model) and ``PoissonChangepointLogJoint``
(``changepoint``'s log joint, the change point held per chain).

Each density's value and gradient against the JAX closure at 1e-10; one K1
plain-version transition (``fused_hmc_step_reference``) on each against
JAX's HMC transition (``HMC._leapfrog`` + ``get_acceptance_rate`` + the MH
select) on the same momentum and uniforms at 1e-10; the sampler's kernel
gate at each example's shape; and the routes that pick a built-in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.model_comparison import loo_compare as j_loo
from examples.state_space import changepoint as j_cp
from examples.toy_examples import neal_funnel_neutra as j_funnel_example
from zhusuan_tpu import transform as jt
from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu.mcmc import neutra_log_joint as j_neutra
from zhusuan_tpu.mcmc import whiten_log_joint as j_whiten
from zhusuan_tpu.mcmc.hmc import HMC as JHMC
from zhusuan_tpu_torch.examples.model_comparison import loo_compare as t_loo
from zhusuan_tpu_torch.examples.state_space import changepoint as t_cp
from zhusuan_tpu_torch.mcmc import base as tbase
from zhusuan_tpu_torch.mcmc import neutra_log_joint as t_neutra
from zhusuan_tpu_torch.mcmc import whiten_log_joint as t_whiten
from zhusuan_tpu_torch.mcmc.hmc import HMC as THMC
from zhusuan_tpu_torch.mcmc.hmc import builtin_density_ineligible
from zhusuan_tpu_torch.ops import hmc_step
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
    GaussianLinearRegressionLogJoint,
    NealFunnelLogJoint,
    NeuTraLogJoint,
    PoissonChangepointLogJoint,
    WhitenedLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import fused_hmc_step_reference

torch.set_num_threads(1)

TOL = 1e-10
C, L = 16, 5


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _torch_value_and_grad(density, name, x, observed=None):
    log_post = tbase.make_log_joint_fn(density, observed or {})
    value = log_post({name: _t(x)})
    return value, tbase.make_grad_fn(log_post)({name: _t(x)})[name]


def _jax_value_and_grad(closure, name, x, observed=None):
    log_post = jbase.make_log_joint_fn(closure, observed or {})
    xj = jnp.asarray(x)
    value = log_post({name: xj})
    grad = jax.grad(lambda v: jnp.sum(log_post({name: v})))(xj)
    return np.asarray(value), np.asarray(grad)


def _jax_transition(closure, name, q, mass, eps, u, step, observed=None):
    """JAX's HMC transition on injected momentum normals and uniforms."""
    log_post = jbase.make_log_joint_fn(closure, observed or {})

    def grad_fn(qq):
        return jax.grad(lambda v: jnp.sum(log_post(v)))(qq)

    hmc = JHMC(n_leapfrogs=L)
    qd = {name: jnp.asarray(q)}
    m = {name: jnp.asarray(mass)}
    p = {name: jnp.asarray(eps) * jnp.sqrt(m[name])}
    nq, np_ = hmc._leapfrog(qd, p, jnp.asarray(step, jnp.float64), grad_fn,
                            m)
    old_h, new_h, old_lp, new_lp, acc = jbase.get_acceptance_rate(
        qd, p, nq, np_, log_post, m, 1)
    take = jnp.asarray(u) < acc
    out_q = jnp.where(take[:, None], nq[name], qd[name])
    new_lp = jnp.where(take, new_lp, old_lp)
    return [np.asarray(v) for v in
            (out_q, p[name], acc, old_lp, new_lp, old_h, new_h)]


def _check_transition(density, closure, name, q, step, seed, observed=None,
                      j_observed=None):
    rs = np.random.RandomState(seed)
    c, d = q.shape
    mass = rs.uniform(0.5, 2.0, (1, d))
    eps, u = rs.randn(c, d), rs.uniform(size=c)
    want = _jax_transition(closure, name, q, mass, eps, u, step, j_observed)
    got = fused_hmc_step_reference(
        density, _t(q), _t(mass), torch.tensor(step, dtype=torch.float64),
        L, None, 1, noise=(_t(eps), _t(u)), observed=observed)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, w)
    # Both MH decisions occur.
    assert 0 < np.mean(u < want[2]) < 1


# --------------------------------------------------------------------- #
# Whitened Gaussians (mixing arm (c))
# --------------------------------------------------------------------- #
def _equi_closure(d, rho):
    a_c = float(1.0 / (1.0 - rho))
    b_c = float(rho / ((1.0 - rho) * (1.0 + (d - 1) * rho)))

    def log_joint(obs):
        z = obs["z"]
        return -0.5 * (a_c * jnp.sum(z * z, -1) - b_c * jnp.sum(z, -1) ** 2)

    return log_joint


def _whitened_case(kind, d=8, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "equicorrelated":
        base = EquicorrelatedGaussianLogJoint("z", d, 0.9)
        closure = _equi_closure(d, 0.9)
        cov = 0.9 * np.ones((d, d)) + 0.1 * np.eye(d)
    else:
        loc, scale = 0.3 * rs.randn(d), rs.uniform(0.5, 1.5, d)
        base = DiagonalGaussianLogJoint("z", _t(loc), _t(scale))
        inv_var = 1.0 / scale ** 2

        def closure(obs):
            return jnp.sum(-0.5 * jnp.square(obs["z"] - loc) * inv_var, -1)

        cov = np.diag(scale ** 2)
    # A pilot's regularised estimate, as fit_dense_preconditioner makes it.
    draws = rs.randn(200, d) @ np.linalg.cholesky(cov).T
    chol = np.linalg.cholesky(np.cov(draws.T) + 1e-3 * np.eye(d))
    return base, closure, chol


@pytest.mark.parametrize("kind", ["equicorrelated", "diagonal"])
def test_whitened_matches_jax(kind):
    base, closure, chol = _whitened_case(kind)
    t_lj, t_to, t_from = t_whiten(base, "z", _t(chol))
    j_lj, _, _ = j_whiten(closure, "z", jnp.asarray(chol))
    assert isinstance(t_lj, WhitenedLogJoint)
    y = np.random.RandomState(1).randn(3, C, 8)
    value, grad = _torch_value_and_grad(t_lj, "z", y)
    j_value, j_grad = _jax_value_and_grad(j_lj, "z", y)
    _close(value, j_value)
    _close(grad, j_grad)
    # value_and_grad (the kernel's arithmetic) is what the sampler sees.
    v2, g2 = t_lj.value_and_grad(_t(y))
    _close(v2, j_value)
    _close(g2, j_grad)
    _check_transition(t_lj, j_lj, "z", t_to(_t(
        np.random.RandomState(2).randn(C, 8) @ chol.T)).numpy(), 0.9, 3)


def test_whitened_pairwise_order_on_float32():
    """The plain version's sums are the pairwise tree on the padded
    columns: at float32 L y equals that tree written out, and a float64
    matrix product to float32 rounding."""
    from zhusuan_tpu_torch.ops.densities import _pairwise_matvec

    rs = np.random.RandomState(4)
    m = torch.tensor(rs.randn(5, 5), dtype=torch.float32)
    v = torch.tensor(rs.randn(3, 5), dtype=torch.float32)
    p = m * v[:, None, :]
    want = ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])) + p[..., 4]
    assert torch.equal(_pairwise_matvec(m, v), want)
    torch.testing.assert_close(_pairwise_matvec(m, v),
                               (v.double() @ m.double().T).float())


# --------------------------------------------------------------------- #
# Neal's funnel and NeuTra
# --------------------------------------------------------------------- #
def _funnel_points(seed, n=C, d=5):
    return 0.5 * np.random.RandomState(seed).randn(n, d)


def test_funnel_matches_jax():
    dens = NealFunnelLogJoint("z", j_funnel_example.D)
    z = _funnel_points(5, 3 * C).reshape(3, C, -1)
    value, grad = _torch_value_and_grad(dens, "z", z)
    j_value, j_grad = _jax_value_and_grad(j_funnel_example.log_joint, "z", z)
    _close(value, j_value)
    _close(grad, j_grad)
    _check_transition(dens, j_funnel_example.log_joint, "z",
                      _funnel_points(6), 0.6, 7)


def _jax_flow(n_flows=8, hidden=32, d=5, seed=0):
    """JAX's flow with its output layers (zero at init) made random, so
    that every coupling moves its half."""
    params = jt.init_affine_coupling(jax.random.PRNGKey(seed), n_flows, d,
                                     hidden=hidden, dtype=jnp.float64)
    rs = np.random.RandomState(seed)
    return [{k: (np.asarray(v) if k == "w1"
                 else 0.05 * rs.randn(*np.shape(v))) for k, v in p.items()}
            for p in params]


@pytest.mark.parametrize("n_flows,hidden,step", [(8, 32, 0.2), (3, 20, 0.5)])
def test_neutra_matches_jax(n_flows, hidden, step):
    flow = _jax_flow(n_flows, hidden)
    j_lj, _, _ = j_neutra(j_funnel_example.log_joint, "z",
                          [{k: jnp.asarray(v) for k, v in p.items()}
                           for p in flow])
    t_lj, _, _ = t_neutra(NealFunnelLogJoint("z", 5), "z",
                          [{k: _t(v) for k, v in p.items()} for p in flow])
    assert isinstance(t_lj, NeuTraLogJoint)
    z = _funnel_points(8, 3 * C).reshape(3, C, -1)
    value, grad = _torch_value_and_grad(t_lj, "z", z)
    j_value, j_grad = _jax_value_and_grad(j_lj, "z", z)
    _close(value, j_value)
    _close(grad, j_grad)
    _check_transition(t_lj, j_lj, "z", _funnel_points(9), step, 10)


def test_neutra_on_a_gaussian_matches_jax():
    flow = _jax_flow(4, 16, d=6, seed=3)
    closure = _equi_closure(6, 0.5)
    j_lj, _, _ = j_neutra(closure, "z", [{k: jnp.asarray(v) for k, v in
                                         p.items()} for p in flow])
    t_lj, _, _ = t_neutra(EquicorrelatedGaussianLogJoint("z", 6, 0.5), "z",
                          [{k: _t(v) for k, v in p.items()} for p in flow])
    assert isinstance(t_lj, NeuTraLogJoint)
    z = np.random.RandomState(11).randn(C, 6)
    value, grad = _torch_value_and_grad(t_lj, "z", z)
    j_value, j_grad = _jax_value_and_grad(j_lj, "z", z)
    _close(value, j_value)
    _close(grad, j_grad)


# --------------------------------------------------------------------- #
# loo_compare's regression and changepoint's HMC block
# --------------------------------------------------------------------- #
def _loo_problem(degree):
    x, y = t_loo.make_data()
    return t_loo.make_design(x, degree), y


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_regression_matches_jax_model(degree):
    X, y = _loo_problem(degree)
    dens = GaussianLinearRegressionLogJoint("w", X, y, 1.0, t_loo.NOISE)
    meta_bn = j_loo.make_model(X, y_group_ndims=1)
    observed = {"y": jnp.asarray(y)}
    w = np.random.RandomState(degree).randn(C, degree + 1)
    value, grad = _torch_value_and_grad(dens, "w", w)
    j_value, j_grad = _jax_value_and_grad(meta_bn, "w", w, observed)
    _close(value, j_value)
    _close(grad, j_grad)
    w0 = 0.5 + 0.2 * np.random.RandomState(degree + 10).randn(C, degree + 1)
    _check_transition(dens, meta_bn, "w", w0, [0.1, 0.05, 0.08][degree],
                      degree + 20, j_observed=observed)


def _changepoint_problem(seed=0):
    y, _ = j_cp.make_data(60, jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    tau = rs.randint(1, 60, (C, 1)).astype(np.float64)
    log_lam = 0.3 * rs.randn(C, 2) + np.log([3.0, 0.8])
    return np.asarray(y, np.float64), tau, log_lam


def test_changepoint_matches_jax():
    y, tau, log_lam = _changepoint_problem()
    dens = PoissonChangepointLogJoint(_t(y))
    closure = j_cp.build_log_joint(jnp.asarray(y))
    value, grad = _torch_value_and_grad(dens, "log_lam", log_lam,
                                        {"tau": _t(tau)})
    j_value, j_grad = _jax_value_and_grad(closure, "log_lam", log_lam,
                                          {"tau": jnp.asarray(tau)})
    _close(value, j_value)
    _close(grad, j_grad)
    # The discrete block scores candidate change points in one batch.
    both = {"tau": _t(tau[None] + np.arange(3)[:, None, None]),
            "log_lam": _t(log_lam)}
    _close(dens(both), closure({k: jnp.asarray(v.numpy())
                                for k, v in both.items()}))
    _check_transition(dens, closure, "log_lam", log_lam, 0.2, 30,
                      observed={"tau": _t(tau)},
                      j_observed={"tau": jnp.asarray(tau)})


def test_changepoint_example_uses_the_builtin():
    lj = t_cp.build_log_joint(torch.tensor([1.0, 2.0, 0.0]))
    assert isinstance(lj, PoissonChangepointLogJoint)


def test_loo_compare_builtin_checked_against_the_model():
    X, y = _loo_problem(1)
    dens = t_loo.regression_builtin(X, y)
    assert isinstance(dens, GaussianLinearRegressionLogJoint)
    with pytest.raises(ValueError, match="differs"):
        t_loo.check_builtin(
            GaussianLinearRegressionLogJoint("w", X, y + 1.0, 1.0,
                                             t_loo.NOISE),
            X, y, torch.zeros(4, 2, dtype=torch.float64))
    t_loo.check_builtin(dens, X, y, torch.zeros(4, 2, dtype=torch.float64))


# --------------------------------------------------------------------- #
# The kernel gate
# --------------------------------------------------------------------- #
def _gate(density, q, observed=None):
    mass = {k: torch.ones(1, v.shape[1]) for k, v in q.items()}
    return THMC._fused_ineligible(density, observed or {}, q, mass, 1)


def test_gate_takes_each_builtin_at_its_example_shape():
    base, _, chol = _whitened_case("equicorrelated", d=100)
    white, _, _ = t_whiten(base, "z", _t(chol))
    assert _gate(white, {"z": torch.zeros(4096, 100)}) is None
    funnel = NealFunnelLogJoint("z", 5)
    assert _gate(funnel, {"z": torch.zeros(512, 5)}) is None
    lifted, _, _ = t_neutra(funnel, "z", [{k: _t(v) for k, v in p.items()}
                                         for p in _jax_flow()])
    assert _gate(lifted, {"z": torch.zeros(512, 5)}) is None
    for degree in (0, 1, 2):
        X, y = _loo_problem(degree)
        reg = GaussianLinearRegressionLogJoint("w", X, y, 1.0, t_loo.NOISE)
        assert _gate(reg, {"w": torch.zeros(32, degree + 1)}) is None
    cp = PoissonChangepointLogJoint(torch.ones(60))
    tau = torch.full((64, 1), 30.0)
    assert _gate(cp, {"log_lam": torch.zeros(64, 2)}, {"tau": tau}) is None


def test_gate_gives_reasons():
    q = {"z": torch.zeros(8, 5)}
    assert "built-in" in _gate(lambda obs: obs["z"].sum(-1), q)
    funnel = NealFunnelLogJoint("z", 5)
    # A per-chain observation the density does not read.
    assert "per-chain" in _gate(funnel, q, {"tau": torch.ones(8, 1)})
    # Other observations stay ignored, as the built-ins ignore them.
    assert _gate(funnel, q, {"data": torch.ones(3)}) is None
    cp = PoissonChangepointLogJoint(torch.ones(60))
    lam = {"log_lam": torch.zeros(8, 2)}
    assert "reads the observations" in _gate(cp, lam)
    assert "[n_chains, 1]" in _gate(cp, lam, {"tau": torch.ones(8)})
    big = WhitenedLogJoint(EquicorrelatedGaussianLogJoint("z", 129, 0.5),
                           torch.eye(129))
    assert "dim <= 128" in _gate(big, {"z": torch.zeros(8, 129)})
    assert "float32" in _gate(funnel, {"z": torch.zeros(
        8, 5, dtype=torch.bfloat16)})
    assert "float32" in _gate(funnel, {"z": torch.zeros(
        8, 5, dtype=torch.float64)})
    # Only K1 takes them.
    for sampler_gate in (builtin_density_ineligible,):
        assert sampler_gate(funnel, {}, q, None, 1, lambda s, t: True,
                            hmc_step.DENSITIES, "") is not None


def test_routes_pick_a_builtin_only_for_builtins():
    chol = torch.eye(4, dtype=torch.float64)
    base = DiagonalGaussianLogJoint("z", torch.zeros(4), torch.ones(4))
    assert isinstance(t_whiten(base, "z", chol)[0], WhitenedLogJoint)
    closure = t_whiten(lambda obs: -(obs["z"] ** 2).sum(-1), "z", chol)[0]
    assert not isinstance(closure, WhitenedLogJoint) and callable(closure)
    # Another latent's name keeps the closure.
    assert not isinstance(t_whiten(base, "x", chol)[0], WhitenedLogJoint)
    flow = [{k: _t(v) for k, v in p.items()} for p in _jax_flow(2, 40)]
    # A hidden width past the kernel's 32 keeps the closure.
    wide = t_neutra(NealFunnelLogJoint("z", 5), "z", flow)[0]
    assert not isinstance(wide, NeuTraLogJoint)
    z = torch.tensor(_funnel_points(12))
    torch.testing.assert_close(
        wide({"z": z}), NeuTraLogJoint(NealFunnelLogJoint("z", 5),
                                       flow)({"z": z}), rtol=1e-12,
        atol=1e-12)


def test_hmc_sample_on_the_changepoint_block_cpu():
    """One Gibbs-style HMC block iteration: the change point comes from
    ``observed``; on the CPU the plain transition runs."""
    y, tau, log_lam = _changepoint_problem(3)
    dens = PoissonChangepointLogJoint(_t(y))
    hmc = THMC(step_size=0.05, n_leapfrogs=6)
    st = hmc.init({"log_lam": _t(log_lam)}, n_chain_dims=1)
    st, info = hmc.sample(dens, {"tau": _t(tau)}, st, (1, 2))
    assert info.acceptance_rate.shape == (C,)
    assert torch.isfinite(st.q["log_lam"]).all()
