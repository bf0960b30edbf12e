"""Tests of the HMC-family kernel body (``ops/hmc_step.py``,
``ops/chees_step.py``, ``ops/leapfrog.py``, ``csrc/hmc_step.cu``): a warp
a chain in the step (K1), trajectory (K2) and ChEES (K7) modes of one
kernel body, its drift dividing by the mass through a reciprocal refined
once a trajectory.

Imports no jax, so its ``cuda`` tests also run on a GPU host:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_hmc_layout.py``.
On the CPU it holds the widths the kernel takes; on the card each mode at
widths of 1, 2 and 4 groups of 4 elements a lane (rows that are not a
multiple of 128) against the plain versions on the same injected noise:
the trajectories bit for bit (the arithmetic is the plain version's, under
``-fmad=false``, and the equicorrelated row sums are float64 on both
sides), the MH decisions up to a near-tie, log-densities within ``LP_TOL``
(their float32 sums are added in another order). The JAX package's parity
is in ``tests/test_torch_ops_hmc_step.py``, ``test_torch_ops_leapfrog.py``
and ``test_torch_chees.py``.
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch.ops import chees_step, hmc_step, leapfrog
from zhusuan_tpu_torch.ops.chees_step import chees_step_supported
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import MAX_DIM, hmc_step_supported

torch.set_num_threads(1)

DENSITIES = ("diagonal", "equicorrelated")
# 1, 1, 2 and 4 groups of 4 elements a lane, none a multiple of 128.
DIMS = (1, 37, 100, 200, 511)
CHAINS = 37
MAX_DIFFERING = 1  # chains whose MH decision flips at a near-tie
LP_TOL = (1e-4, 1e-5)  # (abs, rel)


# --------------------------------------------------------------------- #
# On the CPU: the widths the kernel takes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dim", [1, 4, 37, 100, 128, 129, 256, 257, 384,
                                 385, 511, 512])
def test_every_width_up_to_four_groups_a_lane_is_supported(dim):
    # A lane of the chain's warp holds 1, 2 or 4 groups of 4 elements.
    assert MAX_DIM == 4 * 32 * 4
    assert hmc_step_supported((4096, dim))
    assert hmc_step_supported((4096, dim), torch.bfloat16)
    assert chees_step_supported((4096, dim), torch.float32)
    assert not chees_step_supported((4096, dim), torch.bfloat16)


@pytest.mark.parametrize("dim", [0, MAX_DIM + 1])
def test_no_width_past_the_supported_ones(dim):
    assert not hmc_step_supported((4096, dim))
    assert not chees_step_supported((4096, dim))


# --------------------------------------------------------------------- #
# On the card: each mode against its plain version
# --------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _problem(density, dim, dev, seed=0, unit_mass=False):
    rs = np.random.RandomState(seed + dim)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    if density == "diagonal":
        std = np.linspace(0.1, 1.0, dim)
        dens = DiagonalGaussianLogJoint("x", t(0.1 * rs.randn(dim)), t(std))
        q = t(std * rs.randn(CHAINS, dim))
    else:
        dens = EquicorrelatedGaussianLogJoint("x", dim, 0.95)
        q = t(0.95 ** 0.5 * rs.randn(CHAINS, 1)
              + 0.05 ** 0.5 * rs.randn(CHAINS, dim))
    mass = t(np.ones((1, dim)) if unit_mass else 0.5 + 1.5 * rs.rand(1, dim))
    noise = (t(rs.randn(CHAINS, dim)), t(rs.rand(CHAINS)))
    return dens, q, mass, noise


def _close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= LP_TOL[0] + LP_TOL[1] * want.abs()).all())


def _hold_mh(u, acc_got, acc_want):
    same = (u < acc_got) == (u < acc_want)
    assert int((~same).sum()) <= MAX_DIFFERING
    return same


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("density", DENSITIES)
def test_step_matches_plain_version(density, dim, dtype):
    dev = _cuda()
    dens, q, mass, noise = _problem(density, dim, dev)
    q = q.to(dtype)
    want = hmc_step.fused_hmc_step_reference(dens, q, mass, 0.15, 5, (1, 2),
                                             1, noise=noise)
    before = hmc_step.fused_hmc_step.launches
    got = hmc_step.fused_hmc_step(dens, q, mass, 0.15, 5, (1, 2), 1,
                                  noise=noise)
    torch.cuda.synchronize()
    assert hmc_step.fused_hmc_step.launches == before + 1
    same = _hold_mh(noise[1], got[2], want[2])
    assert torch.equal(got[0][same], want[0][same])  # q'
    assert torch.equal(got[1], want[1])  # p0
    for i in (2, 3, 5, 6):  # acceptance, old log p, both energies
        assert _close(got[i], want[i])
    assert _close(got[4][same], want[4][same])


@pytest.mark.cuda
@pytest.mark.parametrize("per_chain_mass", [False, True],
                         ids=["mass_1xd", "mass_cxd"])
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("density", DENSITIES)
def test_trajectory_matches_plain_version(density, dim, per_chain_mass):
    dev = _cuda()
    dens, q, mass, noise = _problem(density, dim, dev)
    if per_chain_mass:
        rs = np.random.RandomState(dim)
        mass = torch.as_tensor(0.5 + 1.5 * rs.rand(CHAINS, dim),
                               dtype=torch.float32, device=dev)
    p = noise[0]
    want = leapfrog.fused_leapfrog_reference(dens, q, p, 0.15, 5, mass)
    before = leapfrog.fused_leapfrog.launches
    got = leapfrog.fused_leapfrog(dens, q, p, 0.15, 5, mass)
    torch.cuda.synchronize()
    assert leapfrog.fused_leapfrog.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 190])
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("density", DENSITIES)
def test_chees_matches_plain_version(density, dim, n):
    dev = _cuda()
    dens, q, mass, noise = _problem(density, dim, dev, unit_mass=True)
    step = 0.2 if density == "equicorrelated" else 0.15
    n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
    want = chees_step.fused_chees_step_reference(dens, q, mass, step, n_dev,
                                                 (1, 2), 1, noise=noise)
    before = chees_step.fused_chees_step.launches
    got = chees_step.fused_chees_step(dens, q, mass, step, n_dev, (1, 2), 1,
                                      noise=noise)
    torch.cuda.synchronize()
    assert chees_step.fused_chees_step.launches == before + 1
    same = _hold_mh(noise[1], got[3], want[3])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[0][same], want[0][same])
    assert _close(got[4], want[4])
    fin = torch.isfinite(want[3]) & same
    assert _close(got[3][fin], want[3][fin])
    assert _close(got[5][same], want[5][same])


@pytest.mark.cuda
@pytest.mark.parametrize("density", DENSITIES)
def test_chees_divergent_step(density):
    # A step past the stability limit: every chain diverges, and the
    # non-finite proposals (outside the refined reciprocal's range, so
    # through the ordinary division) must be the plain version's.
    dev = _cuda()
    dens, q, mass, noise = _problem(density, 100, dev, unit_mass=True)
    step = 0.5 if density == "equicorrelated" else 0.25
    n_dev = torch.tensor(190, dtype=torch.int32, device=dev)
    want = chees_step.fused_chees_step_reference(dens, q, mass, step, n_dev,
                                                 (1, 2), 1, noise=noise)
    assert bool((~torch.isfinite(want[1]).all(1)).float().mean() > 0.5)
    got = chees_step.fused_chees_step(dens, q, mass, step, n_dev, (1, 2), 1,
                                      noise=noise)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(got[1]), torch.isfinite(want[1]))
    assert torch.equal(got[0], want[0])


# --------------------------------------------------------------------- #
# The built-ins K1 alone evaluates (zs_fused_builtin_hmc_step)
# --------------------------------------------------------------------- #
# Widths of each: the whitened density at 1 to 128 (its rows on 32 lanes,
# L in shared memory), the funnel at 1, 2 and 4 groups a lane, NeuTra at 2
# to 32 with hidden widths 7 and 32, the regression at 1 to 8.
BUILTIN_CASES = ([("whitened", d) for d in (1, 37, 100, 128)]
                 + [("funnel", d) for d in (2, 5, 200, 511)]
                 + [("neutra", d) for d in (2, 5, 32)]
                 + [("regression", d) for d in (1, 3, 8)]
                 + [("changepoint", 2)])
SHARED_BYTES = 227 * 1024  # a block's shared memory on sm_90


def _flow(d, n_flows, hidden, rs, t):
    d1 = d // 2
    out = []
    for i in range(n_flows):
        n_in, n_out = (d1, d - d1) if i % 2 == 0 else (d - d1, d1)
        out.append({"w1": t(rs.randn(n_in, hidden) * (2.0 / n_in) ** 0.5),
                    "b1": t(0.05 * rs.randn(hidden)),
                    "w2": t(0.05 * rs.randn(hidden, 2 * n_out)),
                    "b2": t(0.05 * rs.randn(2 * n_out))})
    return out


def _builtin_problem(kind, dim, dev, seed=0):
    """A built-in of K1's own at ``dim``, positions, a mass, the injected
    noise and the observations it reads."""
    from zhusuan_tpu_torch.ops import densities as zd

    rs = np.random.RandomState(seed + dim)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    observed, step = {}, 0.15
    q = t(0.5 * rs.randn(CHAINS, dim))
    if kind == "whitened":
        a = rs.randn(dim, dim)
        chol = np.linalg.cholesky(0.5 * np.eye(dim) + a @ a.T / dim)
        dens = zd.WhitenedLogJoint(EquicorrelatedGaussianLogJoint(
            "x", dim, 0.5), t(chol))
    elif kind == "funnel":
        dens = zd.NealFunnelLogJoint("x", dim)
    elif kind == "neutra":
        dens = zd.NeuTraLogJoint(zd.NealFunnelLogJoint("x", dim),
                                 _flow(dim, 5, 7 if dim < 32 else 32, rs, t))
        step = 0.1
    elif kind == "regression":
        x = rs.randn(45, dim)
        dens = zd.GaussianLinearRegressionLogJoint(
            "x", x, x @ rs.randn(dim) + 0.3 * rs.randn(45), 1.0, 0.3)
        q, step = t(0.05 * rs.randn(CHAINS, dim)), 0.02
    else:
        y = rs.poisson(np.where(np.arange(70) < 30, 3.0, 0.8))
        dens = zd.PoissonChangepointLogJoint(t(y))
        observed = {"tau": t(rs.randint(1, 70, (CHAINS, 1)))}
        q = t(np.log([3.0, 0.8]) + 0.2 * rs.randn(CHAINS, 2))
    mass = t(0.5 + 1.5 * rs.rand(1, dim))
    noise = (t(rs.randn(CHAINS, dim)), t(rs.rand(CHAINS)))
    return dens, q, mass, noise, observed, step


@pytest.mark.parametrize("kind,dim", BUILTIN_CASES)
def test_builtin_shared_memory_fits_the_card(kind, dim):
    """A block's dynamic shared memory for each built-in at its widths
    (and at its limits) stays within sm_90's 227 KB."""
    dens, *_ = _builtin_problem(kind, dim, torch.device("cpu"))
    assert dens.kernel_ineligible() is None
    _, aux, n_rows, block, warp = hmc_step._builtin_layout(
        dens, torch.device("cpu"))
    assert 4 * (block + 8 * warp) <= SHARED_BYTES
    assert (n_rows > 0) == (kind in ("regression", "changepoint"))
    assert (aux[0] is not None) == (kind in ("whitened", "neutra"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dim", BUILTIN_CASES)
def test_builtin_step_matches_plain_version(kind, dim):
    """K1 on a built-in of its own against its plain version, which sums
    in the kernel's order: q', p0 and both log-densities bit for bit, no
    MH decision flipped; the energies within ``LP_TOL`` (the kinetic
    energy's row sum in another order)."""
    dev = _cuda()
    dens, q, mass, noise, observed, step = _builtin_problem(kind, dim, dev)
    want = hmc_step.fused_hmc_step_reference(
        dens, q, mass, step, 5, (1, 2), 1, noise=noise, observed=observed)
    before = hmc_step.fused_hmc_step.launches
    got = hmc_step.fused_hmc_step(dens, q, mass, step, 5, (1, 2), 1,
                                  noise=noise, observed=observed)
    torch.cuda.synchronize()
    assert hmc_step.fused_hmc_step.launches == before + 1
    u = noise[1]
    assert torch.equal(u < got[2], u < want[2])
    for i in (0, 1, 3, 4):  # q', p0, old and new log p
        assert torch.equal(got[i], want[i])
    fin = torch.isfinite(want[5]) & torch.isfinite(want[6])
    for i in (2, 5, 6):
        assert _close(got[i][fin], want[i][fin])
