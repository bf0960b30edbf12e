"""Parity tests of zhusuan_tpu_torch.ops.leapfrog (the fused leapfrog
trajectory) and of ``HMC(experimental_fused_leapfrog=...)`` against the
JAX package, on the CPU in float64.

The JAX side is the Pallas kernel itself, ``zhusuan_tpu.ops.leapfrog.
fused_leapfrog(..., interpret=True)``, which runs on the CPU; in float64,
because in float32 its carry-dtype check fails whenever the gradient's
constants are float64 under x64. The CUDA kernel is checked against its
plain version on the card (``cuda``-marked tests here, and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.ops.leapfrog import fused_leapfrog as j_fused_leapfrog
from zhusuan_tpu_torch.mcmc.hmc import HMC as THMC
from zhusuan_tpu_torch.mcmc.hmc import builtin_density_ineligible
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)
from zhusuan_tpu_torch.ops.leapfrog import (
    DENSITIES,
    MAX_DIM,
    fused_leapfrog,
    fused_leapfrog_reference,
    leapfrog_supported,
)

torch.set_num_threads(1)

C, D, L = 64, 8, 6
TOL = 1e-12  # float64 on both sides; only the order of row sums differs


def _t(x):
    return torch.as_tensor(np.array(x))


def _densities(d=D):
    """``name -> (JAX log-joint closure, port built-in)``."""
    std = np.linspace(0.3, 1.5, d)
    loc = 0.1 * np.arange(d)
    rho = 0.9
    a_c = float(1.0 / (1.0 - rho))
    b_c = float(rho / ((1.0 - rho) * (1.0 + (d - 1) * rho)))

    def diag(obs):
        return jnp.sum(-0.5 * ((obs["z"] - loc) / std) ** 2, -1)

    def equi(obs):
        z = obs["z"]
        return -0.5 * (a_c * jnp.sum(z * z, -1) - b_c * jnp.sum(z, -1) ** 2)

    return {
        "diagonal": (diag, DiagonalGaussianLogJoint("z", _t(loc), _t(std))),
        "equicorrelated": (equi, EquicorrelatedGaussianLogJoint("z", d,
                                                                rho)),
    }


@pytest.mark.parametrize("density", ["diagonal", "equicorrelated"])
@pytest.mark.parametrize("per_chain_mass", [False, True])
@pytest.mark.parametrize("n_leapfrogs", [0, L])
def test_reference_matches_jax_pallas_kernel(density, per_chain_mass,
                                             n_leapfrogs):
    jlj, tlj = _densities()[density]
    rs = np.random.RandomState(n_leapfrogs + 2 * per_chain_mass)
    q, p = rs.randn(C, D), rs.randn(C, D)
    mass = rs.uniform(0.5, 2.0, (C if per_chain_mass else 1, D))

    def grad(x):
        return jax.grad(lambda v: jnp.sum(jlj({"z": v})))(x)

    want = j_fused_leapfrog(grad, jnp.asarray(q), jnp.asarray(p), 0.17,
                            n_leapfrogs, jnp.asarray(mass), interpret=True)
    got = fused_leapfrog_reference(tlj, _t(q), _t(p), 0.17, n_leapfrogs,
                                   _t(mass))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_cpu_wrapper_runs_reference_without_counting():
    _, tlj = _densities()["equicorrelated"]
    rs = np.random.RandomState(3)
    args = (tlj, _t(rs.randn(C, D)), _t(rs.randn(C, D)), 0.1, L,
            _t(rs.uniform(0.5, 2.0, (C, D))))
    before = fused_leapfrog.launches
    got = fused_leapfrog(*args)
    want = fused_leapfrog_reference(*args)
    assert fused_leapfrog.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,dtype,ok", [
    ((4096, 100), torch.float32, True),
    ((1000, 37), None, True),
    ((8, MAX_DIM), torch.float32, True),
    ((8, MAX_DIM + 1), torch.float32, False),
    ((0, 8), torch.float32, False),
    ((8,), torch.float32, False),
    ((8, 8), torch.bfloat16, False),
    ((8, 8), torch.float64, False),
])
def test_leapfrog_supported(shape, dtype, ok):
    assert leapfrog_supported(shape, dtype) is ok


@pytest.mark.parametrize("change,error", [
    (dict(density=lambda obs: obs["z"].sum(-1)), TypeError),
    (dict(q=torch.zeros(C, D, 2)), ValueError),
    (dict(p=torch.zeros(C, D + 1)), ValueError),
    (dict(mass=torch.ones(2, D)), ValueError),
    (dict(density=EquicorrelatedGaussianLogJoint("z", D + 1, 0.5)),
     ValueError),
    (dict(p=torch.zeros(C, D, device="meta")), ValueError),
])
def test_wrapper_refuses(change, error):
    args = dict(density=EquicorrelatedGaussianLogJoint("z", D, 0.5),
                q=torch.zeros(C, D), p=torch.zeros(C, D), step_size=0.1,
                n_leapfrogs=3, mass=torch.ones(1, D))
    args.update(change)
    with pytest.raises(error):
        fused_leapfrog(**args)


# --------------------------------------------------------------------- #
# HMC(experimental_fused_leapfrog=...)
# --------------------------------------------------------------------- #
def test_hmc_flag_takes_the_plain_trajectory_on_the_cpu():
    _, tlj = _densities()["equicorrelated"]
    kw = dict(step_size=0.2, n_leapfrogs=4, adapt_step_size=True,
              adapt_mass=True, mass_collect_iters=3)
    on = THMC(experimental_fused_leapfrog=True, **kw)
    off = THMC(**kw)
    assert on.experimental_fused_leapfrog
    assert not off.experimental_fused_leapfrog
    st = on.init({"z": torch.zeros(16, D, dtype=torch.float64)},
                 log_joint=tlj)
    a, b = st, st
    before = fused_leapfrog.launches
    for _ in range(5):
        a, ia = on.sample(tlj, {}, a, (1, 2))
        b, ib = off.sample(tlj, {}, b, (1, 2))
        assert torch.equal(a.q["z"], b.q["z"])
        assert torch.equal(ia.acceptance_rate, ib.acceptance_rate)
        assert torch.equal(a.step_size, b.step_size)
    assert fused_leapfrog.launches == before
    # run: the flag carries no cache (as mcmc/hmc.py:850-853), so the two
    # take different (equivalent) trajectories.
    ra, oa = on.run(tlj, {}, st, (3, 4), 8, n_adapt=4)
    rb, ob = off.run(tlj, {}, st, (3, 4), 8, n_adapt=4)
    torch.testing.assert_close(ra.q["z"], rb.q["z"], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(oa["acceptance_rate"], ob["acceptance_rate"],
                               rtol=1e-12, atol=1e-12)


def test_hmc_flag_run_carries_no_cache():
    calls = []

    def log_joint(obs):
        calls.append(1)
        return -0.5 * (obs["z"] ** 2).sum(-1)

    n, n_iters = 3, 4
    # Uncached: per iteration the chain-rank probe (also the old density),
    # n + 1 gradients and the new density. Cached: make_cache's two, then
    # per iteration n gradients and the new density.
    for flag, want in ((True, n_iters * (n + 3)),
                       (False, 2 + n_iters * (n + 1))):
        calls.clear()
        hmc = THMC(step_size=0.3, n_leapfrogs=n,
                   experimental_fused_leapfrog=flag)
        st = hmc.init({"z": torch.zeros(8, 3)}, n_chain_dims=1)
        hmc.run(log_joint, {}, st, (1, 2), n_iters, collect=False)
        assert len(calls) == want


def test_hmc_trajectory_kernel_gate():
    dens = _densities(4)
    hmc = THMC(step_size=0.1, n_leapfrogs=2, experimental_fused_leapfrog=True)
    q = {"z": torch.zeros(8, 4)}
    m = {"z": torch.ones(1, 4)}
    # The trajectory kernel takes both built-ins, float32 only.
    for _, tlj in dens.values():
        assert builtin_density_ineligible(
            tlj, {}, q, m, 1, leapfrog_supported, DENSITIES, "") is None
        assert builtin_density_ineligible(
            tlj, {}, {"z": q["z"].double()}, m, 1, leapfrog_supported,
            DENSITIES, "float32") is not None
    assert "built-in" in builtin_density_ineligible(
        lambda o: o["z"].sum(-1), {}, q, m, 1, leapfrog_supported,
        DENSITIES, "")
    # CPU tensors: no trajectory kernel, whatever the density.
    for _, tlj in dens.values():
        assert hmc._fused_trajectory(tlj, {}, q, m, 1) is None
    off = THMC(step_size=0.1, n_leapfrogs=2)
    assert off._fused_trajectory(dens["diagonal"][1], {}, q, m, 1) is None


# --------------------------------------------------------------------- #
# On the card only: the CUDA kernel against its plain version.
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("density", ["diagonal", "equicorrelated"])
@pytest.mark.parametrize("per_chain_mass", [False, True])
def test_kernel_matches_reference_on_card(density, per_chain_mass):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    _, tlj = _densities()[density]
    if density == "diagonal":
        tlj = DiagonalGaussianLogJoint("z", tlj.loc.float().to(dev),
                                       tlj.scale.float().to(dev))
    rs = np.random.RandomState(5)
    f32 = dict(dtype=torch.float32, device=dev)
    q = torch.as_tensor(rs.randn(C, D), **f32)
    p = torch.as_tensor(rs.randn(C, D), **f32)
    mass = torch.as_tensor(rs.uniform(0.5, 2.0, (C if per_chain_mass else 1,
                                                 D)), **f32)
    before = fused_leapfrog.launches
    got = fused_leapfrog(tlj, q, p, 0.1, L, mass)
    torch.cuda.synchronize()
    assert fused_leapfrog.launches == before + 1
    want = fused_leapfrog_reference(tlj, q, p, 0.1, L, mass)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hmc_flag_launches_the_trajectory_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    tlj = EquicorrelatedGaussianLogJoint("z", D, 0.9)
    hmc = THMC(step_size=0.1, n_leapfrogs=4, experimental_fused_step=False,
               experimental_fused_leapfrog=True)
    st = hmc.init({"z": torch.zeros(C, D, device=dev)}, log_joint=tlj)
    before = fused_leapfrog.launches
    st, _ = hmc.run(tlj, {}, st, (1, 2), 3)
    assert fused_leapfrog.launches == before + 3
    assert torch.isfinite(st.q["z"]).all()
