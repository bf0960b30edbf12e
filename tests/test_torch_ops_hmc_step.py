"""Parity tests of zhusuan_tpu_torch.ops (the fused HMC step and its
random numbers) against the JAX package, on the CPU in float64.

The Pallas kernel ``zhusuan_tpu.ops.hmc_step.fused_hmc_step`` has no CPU
lowering, even interpreted (hardware PRNG), so the JAX side of each test is
the scan-path composition it is held to: ``HMC._leapfrog`` (or
``_leapfrog_cached``) + ``get_acceptance_rate[_cached]`` + the MH select,
with the momentum ``eps * sqrt(m)`` and uniforms injected into both
packages. The CUDA kernel itself is checked against the plain version on
the card (``cuda``-marked tests here, and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu.mcmc.hmc import HMC as JHMC
from zhusuan_tpu_torch.mcmc import base as tbase
from zhusuan_tpu_torch.mcmc.hmc import HMC as THMC
from zhusuan_tpu_torch.mcmc.nuts import NUTS as TNUTS
from zhusuan_tpu_torch.ops import _random
from zhusuan_tpu_torch.ops.densities import Toy2DLogJoint
from zhusuan_tpu_torch.ops.hmc_step import (
    MAX_DIM,
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
    TemperedLogJoint,
    fused_hmc_step,
    fused_hmc_step_reference,
    hmc_step_supported,
)

torch.set_num_threads(1)

C, D, L = 64, 8, 5
TOL = 1e-10


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return dict(
        q=rs.randn(C, D),
        mass=rs.uniform(0.5, 2.0, (1, D)),
        eps=rs.randn(C, D),
        u=rs.uniform(size=C),
        loc=0.3 * rs.randn(D),
        scale=rs.uniform(0.5, 1.5, D),
        step=0.7,
    )


def _equi_closure(d, rho):
    """bench.py:307-313, over the latent "x"."""
    a_c = float(1.0 / (1.0 - rho))
    b_c = float(rho / ((1.0 - rho) * (1.0 + (d - 1) * rho)))

    def log_joint(obs):
        z = obs["x"]
        return -0.5 * (a_c * jnp.sum(z * z, -1) - b_c * jnp.sum(z, -1) ** 2)

    return log_joint


def _jax_step(x, cached, log_joint=None):
    inv_var = 1.0 / np.square(x["scale"])

    def diag(obs):
        return jnp.sum(-0.5 * jnp.square(obs["x"] - x["loc"]) * inv_var, -1)

    log_joint = log_joint or diag

    log_post = jbase.make_log_joint_fn(log_joint, {})

    def grad_fn(qq):
        return jax.grad(lambda v: jnp.sum(log_post(v)))(qq)

    hmc = JHMC(n_leapfrogs=L)
    q = {"x": jnp.asarray(x["q"])}
    m = {"x": jnp.asarray(x["mass"])}
    p = {"x": jnp.asarray(x["eps"]) * jnp.sqrt(m["x"])}
    step = jnp.asarray(x["step"], jnp.float64)
    if cached:
        g0 = grad_fn(q)
        nq, np_, _ = hmc._leapfrog_cached(q, p, step, grad_fn, m, g0)
        old_h, new_h, old_lp, new_lp, acc = jbase.get_acceptance_rate_cached(
            q, p, nq, np_, log_post, m, 1, log_post(q))
    else:
        nq, np_ = hmc._leapfrog(q, p, step, grad_fn, m)
        old_h, new_h, old_lp, new_lp, acc = jbase.get_acceptance_rate(
            q, p, nq, np_, log_post, m, 1)
    take = jnp.asarray(x["u"]) < acc
    out_q = jnp.where(take[:, None], nq["x"], q["x"])
    new_lp = jnp.where(take, new_lp, old_lp)
    return [np.asarray(v) for v in
            (out_q, p["x"], acc, old_lp, new_lp, old_h, new_h)]


def _torch(x, name):
    return torch.as_tensor(x[name], dtype=torch.float64)


def _density(x):
    return DiagonalGaussianLogJoint("x", _torch(x, "loc"), _torch(x, "scale"))


def _torch_cached_step(x):
    """The port's cached transition (``base.hmc_transition`` with the
    carried log-density and gradient, as ``HMC.sample`` runs it)."""
    dens = _density(x)
    log_post = tbase.make_log_joint_fn(dens, {})
    grad_fn = tbase.make_grad_fn(log_post)
    q = {"x": _torch(x, "q")}
    m = {"x": _torch(x, "mass")}
    p = {"x": _torch(x, "eps") * torch.sqrt(m["x"])}
    step = torch.tensor(x["step"], dtype=torch.float64)
    g0 = grad_fn(q)
    (out_q, acc, old_lp, new_lp, old_h, new_h, new_g,
     *_) = tbase.hmc_transition(q, p, _torch(x, "u"), step, L, grad_fn,
                                log_post, m, 1, log_post(q), g0)
    # The kept point's gradient is carried on.
    torch.testing.assert_close(new_g["x"], grad_fn(out_q)["x"], rtol=1e-12,
                               atol=1e-12)
    return [out_q["x"], p["x"], acc, old_lp, new_lp, old_h, new_h]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cached", [False, True])
def test_reference_matches_jax_composition(seed, cached):
    x = _inputs(seed)
    want = _jax_step(x, cached)
    if cached:
        got = _torch_cached_step(x)
    else:
        got = fused_hmc_step_reference(
            _density(x), _torch(x, "q"), _torch(x, "mass"),
            torch.tensor(x["step"], dtype=torch.float64), L, None, 1,
            noise=(_torch(x, "eps"), _torch(x, "u")))
    assert len(got) == 7
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    # Both accept and reject decisions occur at this step size.
    acc = want[2]
    assert 0 < np.mean(x["u"] < acc) < 1


def test_cpu_wrapper_runs_reference_without_counting():
    x = _inputs(2)
    args = (_density(x), _torch(x, "q"), _torch(x, "mass"),
            torch.tensor(x["step"], dtype=torch.float64), L, (3, 4), 7)
    before = fused_hmc_step.launches
    got = fused_hmc_step(*args)
    want = fused_hmc_step_reference(*args)
    assert fused_hmc_step.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_reference_draws_the_kernel_philox_stream():
    x = _inputs(3)
    mass = _torch(x, "mass")
    key, t = (123, 456), 9
    out = fused_hmc_step_reference(_density(x), _torch(x, "q"), mass, 0.1,
                                   L, key, t)
    eps = _random.philox_normal(key, t, (C, D), _random.STREAM_MOMENTUM)
    np.testing.assert_allclose(out[1], eps.double() * torch.sqrt(mass),
                               rtol=1e-15)
    u = _random.philox_uniform(key, t, (C,), _random.STREAM_MH).double()
    acc, new_lp, old_lp = out[2], out[4], out[3]
    take = u < acc
    assert torch.equal(new_lp[~take], old_lp[~take])


def test_reference_bf16_state_rounds_only_the_output():
    x = _inputs(4)
    q32 = _torch(x, "q").float()
    qb = q32.to(torch.bfloat16)
    dens = DiagonalGaussianLogJoint("x", _torch(x, "loc").float(),
                                    _torch(x, "scale").float())
    args = (_torch(x, "mass").float(), 0.2, L, None, 1)
    noise = (_torch(x, "eps").float(), _torch(x, "u").float())
    out_b = fused_hmc_step_reference(dens, qb, *args, noise=noise)
    out_f = fused_hmc_step_reference(dens, qb.float(), *args, noise=noise)
    assert out_b[0].dtype == torch.bfloat16
    assert out_b[1].dtype == torch.float32
    assert torch.equal(out_b[0], out_f[0].to(torch.bfloat16))
    for g, w in zip(out_b[1:], out_f[1:]):
        assert torch.equal(g, w)


def test_nonfinite_proposal_is_rejected():
    x = _inputs(5)
    eps = _torch(x, "eps")
    eps[0, 0] = float("inf")
    out = fused_hmc_step_reference(_density(x), _torch(x, "q"),
                                   _torch(x, "mass"), 0.2, L, None, 1,
                                   noise=(eps, torch.zeros(C,
                                                           dtype=torch.float64)))
    assert out[2][0] == 0.0
    assert torch.equal(out[0][0], _torch(x, "q")[0])
    assert torch.equal(out[4][0], out[3][0])


# --------------------------------------------------------------------- #
# (f) the built-in density against the bench closure (bench.py:72-74)
# --------------------------------------------------------------------- #
def test_diagonal_gaussian_matches_bench_closure():
    rs = np.random.RandomState(6)
    x = rs.randn(C, D)
    target_std = np.linspace(0.1, 1.0, D)

    def log_joint(obs):
        return jnp.sum(-0.5 * (obs["x"] / target_std) ** 2, -1)

    want = np.asarray(log_joint({"x": x}))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(log_joint({"x": v})))(x))
    dens = DiagonalGaussianLogJoint("x", torch.zeros(D, dtype=torch.float64),
                                    torch.as_tensor(target_std))
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(dens({"x": xt}).numpy(), want, rtol=1e-12)
    got_g = tbase.make_grad_fn(tbase.make_log_joint_fn(dens, {}))({"x": xt})
    np.testing.assert_allclose(got_g["x"].numpy(), want_g, rtol=1e-12)
    loc, inv_var = dens.kernel_args("cpu")
    assert loc.dtype == inv_var.dtype == torch.float32
    np.testing.assert_allclose(inv_var.numpy(), 1.0 / target_std ** 2,
                               rtol=1e-6)


def test_diagonal_gaussian_rejects_bad_parameters():
    with pytest.raises(ValueError):
        DiagonalGaussianLogJoint("x", torch.zeros(3), torch.ones(4))
    with pytest.raises(ValueError):
        DiagonalGaussianLogJoint("x", torch.zeros(2, 3), torch.ones(2, 3))


# --------------------------------------------------------------------- #
# (g) the gate and the wrapper's refusals
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,dtype,ok", [
    ((32768, 100), torch.float32, True),
    ((1000, 37), torch.bfloat16, True),
    ((1, 1), None, True),
    ((8, MAX_DIM), torch.float32, True),
    ((8, MAX_DIM + 1), torch.float32, False),
    ((8, 0), torch.float32, False),
    ((0, 8), torch.float32, False),
    ((8,), torch.float32, False),
    ((2, 8, 8), torch.float32, False),
    ((8, 8), torch.float64, False),
    ((8, 8), torch.float16, False),
])
def test_hmc_step_supported(shape, dtype, ok):
    assert hmc_step_supported(shape, dtype) is ok


def _refusal_args():
    x = _inputs(7)
    return dict(density=_density(x), q=_torch(x, "q"),
                mass=_torch(x, "mass"), step_size=0.1, n_leapfrogs=L,
                key=(1, 2), t=1)


@pytest.mark.parametrize("change,error", [
    (dict(density=lambda obs: obs["x"].sum(-1)), TypeError),
    (dict(q=torch.zeros(C, D, 2, dtype=torch.float64)), ValueError),
    (dict(mass=torch.ones(C, D, dtype=torch.float64)), ValueError),
    (dict(density=DiagonalGaussianLogJoint(
        "x", torch.zeros(D + 1), torch.ones(D + 1))), ValueError),
    (dict(q=torch.zeros(C, D, device="meta"),
          mass=torch.ones(1, D, device="meta")), ValueError),
    (dict(mass=torch.ones(1, D, device="meta")), ValueError),
    (dict(noise=(torch.zeros(C, D + 1), torch.zeros(C))), ValueError),
    (dict(noise=(torch.zeros(C, D), torch.zeros(C + 1))), ValueError),
])
def test_wrapper_refuses(change, error):
    args = _refusal_args()
    args.update(change)
    noise = args.pop("noise", None)
    with pytest.raises(error):
        fused_hmc_step(*args.values(), noise=noise)


# --------------------------------------------------------------------- #
# (h) the equicorrelated built-in (bench.py:297-313) and the gates
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("d,rho", [(D, 0.95), (100, 0.95), (5, -0.2)])
def test_equicorrelated_matches_bench_closure(d, rho):
    x = np.random.RandomState(9).randn(C, d)
    jlj = _equi_closure(d, rho)
    want = np.asarray(jlj({"x": x}))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jlj({"x": v})))(x))
    dens = EquicorrelatedGaussianLogJoint("x", d, rho)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(dens({"x": xt}).numpy(), want, rtol=1e-12,
                               atol=1e-12)
    got_g = tbase.make_grad_fn(tbase.make_log_joint_fn(dens, {}))({"x": xt})
    np.testing.assert_allclose(got_g["x"].numpy(), want_g, rtol=1e-12,
                               atol=1e-12)
    # The closed form is the Gaussian with covariance rho 11^T + (1-rho) I.
    cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    quad = -0.5 * np.einsum("ci,ij,cj->c", x, np.linalg.inv(cov), x)
    np.testing.assert_allclose(want, quad, rtol=1e-9)
    ab, unused = dens.kernel_args("cpu")
    assert unused is None and ab.dtype == torch.float32
    # Second derivatives through the written-out gradient: minus the
    # precision a I - b 11^T.
    hess = torch.autograd.functional.hessian(dens.log_prob, xt[0])
    np.testing.assert_allclose(
        hess.numpy(), -(dens.a * np.eye(d) - dens.b * np.ones((d, d))),
        rtol=1e-12, atol=1e-12)
    # The kernel evaluates the centred form a sum((z - s/d)^2) + c s^2.
    np.testing.assert_allclose(ab.numpy(), [dens.a, dens.c, 1.0 / d],
                               rtol=1e-7)
    np.testing.assert_allclose(dens.c, dens.a / d - dens.b, rtol=1e-12)


@pytest.mark.parametrize("kwargs", [dict(dim=0, rho=0.5),
                                    dict(dim=4, rho=1.0),
                                    dict(dim=4, rho=-0.5)])
def test_equicorrelated_rejects_bad_parameters(kwargs):
    with pytest.raises(ValueError):
        EquicorrelatedGaussianLogJoint("x", **kwargs)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_composition_equicorrelated(seed):
    x = _inputs(seed)
    x["q"] = x["q"] * 0.5
    x["step"] = 0.3
    want = _jax_step(x, False, _equi_closure(D, 0.9))
    got = fused_hmc_step_reference(
        EquicorrelatedGaussianLogJoint("x", D, 0.9), _torch(x, "q"),
        _torch(x, "mass"), torch.tensor(x["step"], dtype=torch.float64), L,
        None, 1, noise=(_torch(x, "eps"), _torch(x, "u")))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
    assert 0 < np.mean(x["u"] < want[2]) < 1


def test_kernel_gates_take_their_builtins():
    """The HMC kernel takes both built-ins; NUTS only the diagonal one,
    and says which it takes."""
    q = {"x": torch.zeros(8, 4)}
    m = {"x": torch.ones(1, 4)}
    diag = DiagonalGaussianLogJoint("x", torch.zeros(4), torch.ones(4))
    equi = EquicorrelatedGaussianLogJoint("x", 4, 0.9)
    assert THMC._fused_ineligible(diag, {}, q, m, 1) is None
    assert THMC._fused_ineligible(equi, {}, q, m, 1) is None
    nuts = TNUTS(max_tree_depth=5)
    assert nuts._fused_ineligible(diag, {}, q, m, 1) is None
    reason = nuts._fused_ineligible(equi, {}, q, m, 1)
    assert "built-in" in reason and "DiagonalGaussianLogJoint" in reason
    assert "Equicorrelated" not in reason
    # NUTS still samples the equicorrelated density, on the plain path.
    st = nuts.init({"x": torch.zeros(8, 4)}, log_joint=equi)
    st, info = nuts.sample(equi, {}, st, (1, 2))
    assert st.t == 1 and torch.isfinite(st.q["x"]).all()
    with pytest.raises(TypeError):
        from zhusuan_tpu_torch.ops.nuts_step import fused_nuts_transition
        fused_nuts_transition(equi, torch.zeros(8, 4), torch.ones(1, 4), 0.1,
                              3, 1000.0, (1, 2), 1)


# --------------------------------------------------------------------- #
# (i) the tempered bridge (annealed SMC's HMC moves)
# --------------------------------------------------------------------- #
def _bridge_parts(x, pair):
    """The two built-ins of a bridge (``"diagonal"`` is ``_density(x)``,
    ``"standard"`` N(0, I), ``"equicorrelated"`` rho 0.9) and JAX closures
    of them."""
    inv_var = 1.0 / np.square(x["scale"])
    parts = {
        "diagonal": (_density(x), lambda obs: jnp.sum(
            -0.5 * jnp.square(obs["x"] - x["loc"]) * inv_var, -1)),
        "standard": (DiagonalGaussianLogJoint(
            "x", torch.zeros(D, dtype=torch.float64),
            torch.ones(D, dtype=torch.float64)),
            lambda obs: jnp.sum(-0.5 * jnp.square(obs["x"]), -1)),
        "equicorrelated": (EquicorrelatedGaussianLogJoint("x", D, 0.9),
                           _equi_closure(D, 0.9)),
    }
    return [parts[name] for name in pair]


BRIDGE_PAIRS = [("standard", "diagonal"), ("diagonal", "equicorrelated"),
                ("equicorrelated", "standard")]


@pytest.mark.parametrize("pair", BRIDGE_PAIRS)
@pytest.mark.parametrize("beta", [0.0, 0.37, 1.0])
def test_tempered_reference_matches_jax_closure(pair, beta):
    """K1's plain version on the bridge against JAX's composition on the
    tempered closure ``(1 - beta) log p0 + beta log p1``."""
    x = _inputs(10)
    x["q"] = x["q"] * 0.5
    x["step"] = 0.6  # both MH decisions occur at beta 0.37
    (p0, j0), (p1, j1) = _bridge_parts(x, pair)
    b = jnp.float64(beta)
    want = _jax_step(x, False, lambda obs: (1.0 - b) * j0(obs)
                     + b * j1(obs))
    got = fused_hmc_step_reference(
        TemperedLogJoint(p0, p1, torch.tensor(beta, dtype=torch.float64)),
        _torch(x, "q"), _torch(x, "mass"),
        torch.tensor(x["step"], dtype=torch.float64), L, None, 1,
        noise=(_torch(x, "eps"), _torch(x, "u")))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
    if beta == 0.37:
        assert 0 < np.mean(x["u"] < want[2]) < 1


@pytest.mark.parametrize("pair", BRIDGE_PAIRS)
def test_tempered_value_and_grad(pair):
    """``value_and_grad`` (the kernel's arithmetic) against ``log_prob``
    and its autograd gradient, and the weights at the ladder's ends."""
    x = _inputs(11)
    (p0, _), (p1, _) = _bridge_parts(x, pair)
    q = _torch(x, "q").requires_grad_(True)
    for beta in (0.0, 0.25, 1.0):
        dens = TemperedLogJoint(p0, p1, torch.tensor(beta,
                                                     dtype=torch.float64))
        lp = dens.log_prob(q)
        (g,) = torch.autograd.grad(lp.sum(), q)
        v, g2 = dens.value_and_grad(q.detach())
        torch.testing.assert_close(v, lp.detach(), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(g2, g, rtol=1e-12, atol=1e-12)
        end = {0.0: p0, 1.0: p1}.get(beta)
        if end is not None:
            torch.testing.assert_close(lp.detach(), end.log_prob(q.detach()),
                                       rtol=0, atol=0)


def test_tempered_rejects_bad_parts():
    x = _inputs(12)
    diag = _density(x)
    with pytest.raises(TypeError, match="prior must be one of"):
        TemperedLogJoint(Toy2DLogJoint("x"), diag, 0.5)
    with pytest.raises(TypeError, match="target must be one of"):
        TemperedLogJoint(diag, lambda obs: obs["x"].sum(-1), 0.5)
    with pytest.raises(ValueError, match="one latent of one dim"):
        TemperedLogJoint(diag, EquicorrelatedGaussianLogJoint("x", D + 1,
                                                              0.5), 0.5)
    with pytest.raises(ValueError, match="one latent of one dim"):
        TemperedLogJoint(diag, EquicorrelatedGaussianLogJoint("y", D, 0.5),
                         0.5)


def test_tempered_takes_only_the_hmc_step_kernel():
    """HMC's whole-step kernel takes the bridge; NUTS's, ChEES's and the
    trajectory kernel's do not."""
    from zhusuan_tpu_torch.mcmc.chees import ChEESHMC
    from zhusuan_tpu_torch.ops.chees_step import fused_chees_step
    from zhusuan_tpu_torch.ops.leapfrog import fused_leapfrog

    q = {"x": torch.zeros(8, 4)}
    m = {"x": torch.ones(1, 4)}
    bridge = TemperedLogJoint(
        DiagonalGaussianLogJoint("x", torch.zeros(4), torch.ones(4)),
        EquicorrelatedGaussianLogJoint("x", 4, 0.9), 0.5)
    assert THMC._fused_ineligible(bridge, {}, q, m, 1) is None
    assert TNUTS(max_tree_depth=5)._fused_ineligible(bridge, {}, q, m,
                                                     1) is not None
    assert ChEESHMC._fused_ineligible(bridge, {}, q, m, 1) is not None
    with pytest.raises(TypeError):
        fused_leapfrog(bridge, q["x"], q["x"], 0.1, 3, m["x"])
    with pytest.raises(TypeError):
        fused_chees_step(bridge, q["x"], m["x"], 0.1, 3, (1, 2), 1)


# --------------------------------------------------------------------- #
# random numbers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    words = [torch.tensor(c, dtype=torch.int64) for c in ctr]
    got = _random.philox4x32_10(*words, *key)
    assert tuple(int(g) for g in got) == want


def test_uniform_from_bits_mantissa_trick():
    bits = np.array([0, 1 << 9, 0xFFFFFFFF, 0x80000000, 12345678],
                    dtype=np.uint32)
    want = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - 1.0
    got = _random.uniform_from_bits(torch.as_tensor(bits.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_split_boxmuller_uses_both_outputs():
    b1 = torch.tensor([0, 1 << 31, 0xFFFFFFFF], dtype=torch.int64)
    b2 = torch.tensor([1 << 30, 1 << 29, 1 << 31], dtype=torch.int64)
    c, s = _random.split_boxmuller_normal(b1, b2)
    u1 = np.maximum(_random.uniform_from_bits(b1).numpy(), np.float32(1e-7))
    u2 = _random.uniform_from_bits(b2).numpy()
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    np.testing.assert_allclose(c.numpy(), r * np.cos(2 * np.pi * u2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), r * np.sin(2 * np.pi * u2),
                               rtol=1e-5, atol=1e-6)


def test_philox_normal_layout_and_moments():
    key, t = (11, 22), 5
    x = _random.philox_normal(key, t, (64, 37), 1)
    assert x.shape == (64, 37) and x.dtype == torch.float32
    # Columns 4g..4g+3 of a row come from one counter; the ragged tail is
    # cut from the last group.
    wide = _random.philox_normal(key, t, (64, 40), 1)
    assert torch.equal(x, wide[:, :37])
    assert torch.equal(_random.philox_normal(key, t, (64, 37), 1), x)
    assert not torch.equal(_random.philox_normal(key, t + 1, (64, 37), 1), x)
    assert not torch.equal(_random.philox_normal(key, t, (64, 37), 2), x)
    big = _random.philox_normal((5, 6), 1, (4096, 64), 1).double()
    assert abs(float(big.mean())) < 0.005
    assert abs(float(big.std()) - 1.0) < 0.005


def test_philox_key_from_generator_is_reproducible():
    k1 = _random.philox_key(torch.Generator().manual_seed(3))
    k2 = _random.philox_key(torch.Generator().manual_seed(3))
    k3 = _random.philox_key(torch.Generator().manual_seed(4))
    assert k1 == k2 and k1 != k3
    assert all(0 <= k < 2 ** 32 for k in k1)


# --------------------------------------------------------------------- #
# On the card only: the CUDA kernel against its plain version.
# --------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")


@pytest.mark.cuda
@pytest.mark.parametrize("density", ["diagonal", "equicorrelated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_reference_on_card(dtype, density):
    _need_cuda()
    dev = torch.device("cuda")
    x = _inputs(8)
    q = _torch(x, "q").to(dev, dtype)
    mass = _torch(x, "mass").to(dev, torch.float32)
    if density == "equicorrelated":
        dens = EquicorrelatedGaussianLogJoint("x", D, 0.9)
    else:
        dens = DiagonalGaussianLogJoint("x", _torch(x, "loc").float().to(dev),
                                        _torch(x, "scale").float().to(dev))
    noise = (_torch(x, "eps").float().to(dev), _torch(x, "u").float().to(dev))
    before = fused_hmc_step.launches
    got = fused_hmc_step(dens, q, mass, 0.2, L, (1, 2), 1, noise=noise)
    torch.cuda.synchronize()
    assert fused_hmc_step.launches == before + 1
    want = fused_hmc_step_reference(dens, q, mass, 0.2, L, (1, 2), 1,
                                    noise=noise)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", BRIDGE_PAIRS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tempered_kernel_matches_reference_on_card(dtype, pair):
    _need_cuda()
    dev = torch.device("cuda")
    x = _inputs(13)
    q = (0.5 * _torch(x, "q")).to(dev, dtype)
    mass = _torch(x, "mass").to(dev, torch.float32)
    (p0, _), (p1, _) = _bridge_parts(x, pair)

    def on_card(d):
        if isinstance(d, EquicorrelatedGaussianLogJoint):
            return d
        return DiagonalGaussianLogJoint("x", d.loc.float().to(dev),
                                        d.scale.float().to(dev))

    dens = TemperedLogJoint(on_card(p0), on_card(p1),
                            torch.tensor(0.37, device=dev))
    noise = (_torch(x, "eps").float().to(dev), _torch(x, "u").float().to(dev))
    before = fused_hmc_step.launches
    got = fused_hmc_step(dens, q, mass, 0.3, L, (1, 2), 1, noise=noise)
    torch.cuda.synchronize()
    assert fused_hmc_step.launches == before + 1
    want = fused_hmc_step_reference(dens, q, mass, 0.3, L, (1, 2), 1,
                                    noise=noise)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_true_raises_on_ineligible_cuda_input():
    _need_cuda()
    dev = torch.device("cuda")
    hmc = THMC(step_size=0.1, n_leapfrogs=3, experimental_fused_step=True)
    st = hmc.init({"x": torch.zeros(16, 4, device=dev)}, n_chain_dims=1)
    with pytest.raises(ValueError):
        hmc.sample(lambda obs: -0.5 * (obs["x"] ** 2).sum(-1), {}, st, (1, 2))
