"""Tests of the NUTS kernel's layouts (``ops/nuts_step.py``,
``csrc/nuts_step.cu``): a chain on a group of ``L`` lanes (8, 16 or 32,
from the width), the checkpoint stacks in shared or global memory.

Imports no jax, so its ``cuda`` tests also run on a GPU host:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_nuts_layout.py``.
On the CPU it holds the layout rule and the shared-memory rule to sm_90's
limits; on the card both stack placements of the kernel at widths of every
lane count against the plain version (``fused_nuts_transition_reference``)
on the same injected noise and on the kernel's own Philox draws, and the
carried-gradient body on the built-ins over several latents with data
(eight schools, ordinal, Weibull AFT). The JAX package's parity for the
transition is in ``tests/test_torch_nuts.py`` and
``tests/test_torch_examples_robust.py``.
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch.ops import nuts_step
from zhusuan_tpu_torch.ops.densities import DiagonalGaussianLogJoint
from zhusuan_tpu_torch.ops.nuts_step import (
    BLOCK_SHARED_BYTES,
    MAX_DIM,
    MAX_TREE_DEPTH,
    fused_nuts_transition,
    fused_nuts_transition_reference,
    nuts_lanes,
    nuts_layout,
    nuts_noise,
    nuts_resident_chains,
    nuts_shared_bytes,
)

torch.set_num_threads(1)

# 8 lanes a chain up to 128 dims (1, 2 and 4 groups of 4 a lane), 16 lanes
# at 129, 32 at 512.
DIMS = (1, 4, 37, 100, 128, 129, 512)
DEPTHS = (1, 2, 6, 7, 8, 10, 12)
# A chain count that leaves the last warp ragged (4 and 2 chains a warp at
# 8 and 16 lanes).
CHAINS = 37
# The kernel adds its row sums in another order than torch, so a near-tie in
# a U-turn or selection test may flip one chain's tree or proposal.
MAX_DIFFERING = 1
Q_TOL = 1e-5  # the leapfrog arithmetic is the same on both sides
LP_TOL = (1e-4, 1e-5)  # (abs, rel) on log_prob, energy; abs on accept_stat


# --------------------------------------------------------------------- #
# On the CPU: the layout rule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dim,want", [
    (1, 8), (2, 8), (4, 8), (16, 8), (33, 8), (37, 8), (100, 8), (128, 8),
    (129, 16), (256, 16), (257, 32), (511, 32), (512, 32)])
def test_lanes_of_every_width(dim, want):
    # The narrowest chain whose lanes hold the row in at most 4 groups of 4.
    assert nuts_lanes(dim) == want
    assert dim <= 16 * want


@pytest.mark.parametrize("dim", [0, MAX_DIM + 1])
def test_no_lanes_past_the_supported_widths(dim):
    with pytest.raises(ValueError, match="dim"):
        nuts_lanes(dim)


@pytest.mark.parametrize("depth", range(1, MAX_TREE_DEPTH + 1))
@pytest.mark.parametrize("dim", DIMS)
def test_every_layout_fits_one_block(dim, depth):
    # sm_90 gives a block at most 227 KB of shared memory: every width the
    # kernel takes fits with its stacks in either place, even a depth-12
    # tree's stacks in shared memory.
    for shared in (True, False):
        assert nuts_shared_bytes(dim, depth, shared) <= BLOCK_SHARED_BYTES
        assert nuts_resident_chains(dim, depth, shared) > 0


def test_shared_bytes_follow_the_rows():
    # d = 100: 25 float4s a row; 4 chains a block at 8 lanes; the far edge
    # and the proposal (3 rows) and 2 (D - 1) stack rows.
    assert nuts_shared_bytes(100, 10, True) == 4 * 21 * 25 * 16
    assert nuts_shared_bytes(100, 10, False) == 4 * 3 * 25 * 16
    assert nuts_shared_bytes(100, 1, True) == 4 * 5 * 25 * 16
    assert nuts_shared_bytes(200, 6, True) == 2 * 13 * 50 * 16
    assert nuts_shared_bytes(512, 12, True) == 1 * 25 * 128 * 16


@pytest.mark.parametrize("depth,want", [(6, 40), (8, 32), (10, 24)])
def test_resident_chains_of_the_main_shape(depth, want):
    # The numbers of csrc/nuts_step.cu's header: (228 KB) // (block + 1 KB)
    # blocks of 4 chains.
    assert nuts_resident_chains(100, depth, True) == want


def test_resident_chains_cap_at_32_blocks():
    assert nuts_resident_chains(512, 1, False) == 32  # 1 chain a block
    assert nuts_resident_chains(1, 1, False) == 128  # 4 chains a block


def test_too_large_a_block_holds_no_chain(monkeypatch):
    monkeypatch.setattr(nuts_step, "BLOCK_SHARED_BYTES", 1000)
    assert nuts_resident_chains(100, 10, True) == 0


@pytest.mark.parametrize("dim,depth,chains,want", [
    # The main shape, as measured: shared stacks at depths 6 and 8 (5280
    # and 4224 chains resident), global at 10 (3168 resident).
    (100, 6, 4096, (8, True)),
    (100, 8, 4096, (8, True)),
    (100, 10, 4096, (8, False)),
    (100, 10, 3168, (8, True)),
    (100, 10, 3169, (8, False)),
    # 13 blocks of 4 chains an SM: 6864 resident.
    (37, 12, 4096, (8, True)),
    # 10 blocks of 2 chains: 2640.
    (200, 6, 4096, (16, False)),
    (200, 6, 2640, (16, True)),
    # 4 blocks of 1 chain: 528.
    (512, 12, 4096, (32, False)),
    (512, 12, 528, (32, True)),
    # 32 blocks (the cap) of 4 chains: 16896.
    (1, 1, 16896, (8, True)),
    (1, 1, 100000, (8, False)),
])
def test_layout_choice_pinned(dim, depth, chains, want):
    assert nuts_layout(dim, depth, chains) == want


@pytest.mark.parametrize("chains", [1, 37, 4096, 100000])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dim", DIMS)
def test_layout_choice(dim, depth, chains):
    # Shared stacks exactly when they leave every chain resident at once.
    lanes, shared = nuts_layout(dim, depth, chains)
    assert lanes == nuts_lanes(dim)
    resident = nuts_step.H100_SMS * nuts_resident_chains(dim, depth, True)
    assert shared == (chains <= resident)
    assert nuts_layout(dim, depth, chains) == (lanes, shared)  # pure


def test_launch_refuses_stacks_that_do_not_fit_shared_memory(monkeypatch):
    monkeypatch.setattr(nuts_step, "BLOCK_SHARED_BYTES", 1000)
    dens = DiagonalGaussianLogJoint("x", torch.zeros(100), torch.ones(100))
    q = torch.zeros(4, 100)
    with pytest.raises(ValueError, match="shared memory"):
        nuts_step._launch(dens, q, torch.ones(1, 100), 0.1, 6, 1000.0,
                          (1, 2), 1, None, True)


# --------------------------------------------------------------------- #
# On the card: both stack placements against the plain version
# --------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _problem(dim, depth, dev, seed=0):
    rs = np.random.RandomState(seed + 97 * dim + depth)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    std = np.linspace(0.1, 1.0, dim)
    dens = DiagonalGaussianLogJoint("x", t(0.1 * rs.randn(dim)), t(std))
    q = t(0.1 * rs.randn(dim) + std * rs.randn(CHAINS, dim))
    inv_mass = t(0.5 + 1.5 * rs.rand(1, dim))
    D = depth
    noise = (t(rs.randn(CHAINS, dim)), t(rs.rand(CHAINS, D)),
             t(rs.rand(CHAINS, (1 << D) - 1)), t(rs.rand(CHAINS, D)))
    return dens, q, inv_mass, noise


LAYOUTS = (True, False)  # checkpoint stacks in shared memory or not


def _compare(got, want):
    same_tree = ((got[4] == want[4]) & (got[5] == want[5])
                 & (got[6] == want[6]) & (got[7] == want[7]))
    q_err = (got[0] - want[0]).abs().amax(dim=1)
    same = same_tree & (q_err <= Q_TOL * (1.0 + want[0].abs().amax(1)))
    assert int((~same).sum()) <= MAX_DIFFERING
    for i in (1, 2):
        err = (got[i] - want[i])[same].abs()
        assert bool((err <= LP_TOL[0] + LP_TOL[1] * want[i][same].abs()).all())
    assert bool(((got[3] - want[3])[same].abs() <= LP_TOL[0]).all())


_REFERENCE = {}


def _reference(dim, depth, injected, dev):
    key = (dim, depth, injected)
    if key not in _REFERENCE:
        dens, q, inv_mass, noise = _problem(dim, depth, dev)
        want = fused_nuts_transition_reference(
            dens, q, inv_mass, 0.1, depth, 1000.0, (5, 6), 2,
            noise=noise if injected else None)
        _REFERENCE[key] = (dens, q, inv_mass, noise, want)
    return _REFERENCE[key]


@pytest.mark.cuda
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "own"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("dim", DIMS)
def test_every_layout_matches_plain_version(dim, depth, injected):
    dev = _cuda()
    dens, q, inv_mass, noise, want = _reference(dim, depth, injected, dev)
    for shared in LAYOUTS:
        before = fused_nuts_transition.launches
        got = nuts_step._launch(dens, q, inv_mass, 0.1, depth, 1000.0, (5, 6),
                                2, noise if injected else None, shared)
        torch.cuda.synchronize()
        assert fused_nuts_transition.launches == before + 1
        _compare(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [37, 100, 512])
def test_own_draws_equal_the_plain_philox_on_every_layout(dim):
    dev = _cuda()
    depth = 8
    dens, q, inv_mass, _ = _problem(dim, depth, dev)
    drawn = nuts_noise((7, 8), 3, CHAINS, dim, depth, dev)
    for shared in LAYOUTS:
        own = nuts_step._launch(dens, q, inv_mass, 0.1, depth, 1000.0, (7, 8),
                                3, None, shared)
        inj = nuts_step._launch(dens, q, inv_mass, 0.1, depth, 1000.0, (7, 8),
                                3, drawn, shared)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(own, inj))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", LAYOUTS, ids=["shared", "global"])
@pytest.mark.parametrize("dim", [37, 200, 300], ids=["L8", "L16", "L32"])
def test_chains_of_one_warp_stopping_at_different_leaves(dim, shared):
    # Coordinate 0 has std 0.01, unstable at step 0.1; the others are nearly
    # flat, so a chain that never moves coordinate 0 drifts to the depth cap.
    # Chain 0 starts off coordinate 0's mean and diverges at its first leaf;
    # chain 1 keeps coordinate 0 still and runs the full depth; chain 2
    # moves it a little and diverges after a few leaves.
    dev = _cuda()
    depth, chains = 8, 37
    rs = np.random.RandomState(3)
    scale = np.full(dim, 1000.0)
    scale[0] = 0.01
    dens = DiagonalGaussianLogJoint(
        "x", torch.zeros(dim, device=dev),
        torch.as_tensor(scale, dtype=torch.float32, device=dev))
    q = torch.as_tensor(rs.randn(chains, dim), dtype=torch.float32, device=dev)
    eps = torch.as_tensor(rs.randn(chains, dim), dtype=torch.float32,
                          device=dev)
    q[:, 0] = 0.0
    eps[:, 0] = 0.0
    q[0, 0] = 1.0
    eps[2, 0] = 1e-3
    D = depth
    noise = (eps,
             torch.as_tensor(rs.rand(chains, D), dtype=torch.float32,
                             device=dev),
             torch.as_tensor(rs.rand(chains, (1 << D) - 1),
                             dtype=torch.float32, device=dev),
             torch.as_tensor(rs.rand(chains, D), dtype=torch.float32,
                             device=dev))
    inv_mass = torch.ones(1, dim, device=dev)
    got = nuts_step._launch(dens, q, inv_mass, 0.1, depth, 1000.0, (1, 2), 1,
                            noise, shared)
    want = fused_nuts_transition_reference(dens, q, inv_mass, 0.1, depth,
                                           1000.0, (1, 2), 1, noise=noise)
    torch.cuda.synchronize()
    assert bool(want[7][0]) and int(want[5][0]) == 1
    assert int(want[4][1]) == depth and int(want[5][1]) == (1 << depth) - 1
    assert bool(want[7][2]) and 1 < int(want[5][2]) < (1 << depth) - 1
    _compare(got, want)
    for i in (4, 5, 6, 7):
        assert torch.equal(got[i][:3], want[i][:3])


# --------------------------------------------------------------------- #
# The built-ins over several latents with data (the carried-gradient body)
# --------------------------------------------------------------------- #
def _data_builtins():
    """The three data built-ins at the examples' shapes, on synthetic data
    made with numpy."""
    from zhusuan_tpu_torch.ops.densities import (
        EightSchoolsLogJoint, OrderedLogisticRegressionLogJoint,
        WeibullAFTLogJoint,
    )

    rs = np.random.RandomState(16)
    x2 = rs.randn(400, 2)
    cut = np.array([-1.0, 0.3, 1.5])
    eta = x2 @ np.array([1.2, -0.8])
    y_ord = np.sum(rs.rand(400, 1) > 1.0 / (1.0 + np.exp(-(cut - eta[:, None]))),
                   axis=-1)
    x3 = np.concatenate([np.ones((500, 1)), rs.randn(500, 2)], -1)
    t = np.exp(x3 @ np.array([0.7, 0.8, -0.5])) * (-np.log(rs.rand(500))) \
        ** (1 / 1.5)
    c = -3.0 * np.log(rs.rand(500))
    y8 = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    s8 = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    return {
        "eight_schools": EightSchoolsLogJoint(y8, s8),
        "eight_schools_centred": EightSchoolsLogJoint(y8, s8, True),
        "ordinal": OrderedLogisticRegressionLogJoint(x2, y_ord, 4),
        "survival": WeibullAFTLogJoint(x3, np.minimum(t, c), c),
    }


def test_a_built_in_with_data_keeps_the_far_gradient_row():
    """One more shared row a chain, and 8 or 32 lanes a chain by its data
    rows."""
    assert nuts_step.nuts_data_lanes(8) == 8
    assert nuts_step.nuts_data_lanes(32) == 8
    assert nuts_step.nuts_data_lanes(33) == 32
    for depth, shared in ((6, True), (8, True), (8, False)):
        assert (nuts_shared_bytes(10, depth, shared, 8)
                - nuts_shared_bytes(10, depth, shared)) == 4 * 3 * 16
        assert nuts_shared_bytes(5, depth, shared, 400) == nuts_shared_bytes(
            5, depth, shared, 8) // 4
    assert nuts_step.nuts_layout(10, 8, 32, 8) == (8, True)
    assert nuts_step.nuts_layout(5, 6, 32, 400) == (32, True)
    assert nuts_step.nuts_layout(10, 8, 32) == (8, True)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 6, 8])
@pytest.mark.parametrize("name", ["eight_schools", "eight_schools_centred",
                                  "ordinal", "survival"])
def test_data_builtins_match_plain_version(name, depth):
    dev = _cuda()
    dens = _data_builtins()[name]
    rs = np.random.RandomState(depth)
    chains, dim = 37, dens.dim

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    q = t(0.5 * rs.randn(chains, dim))
    inv_mass = t(0.5 + rs.rand(1, dim))
    noise = (t(rs.randn(chains, dim)), t(rs.rand(chains, depth)),
             t(rs.rand(chains, (1 << depth) - 1)), t(rs.rand(chains, depth)))
    want = fused_nuts_transition_reference(dens, q, inv_mass, 0.1, depth,
                                           1000.0, (3, 4), 1, noise=noise)
    for shared in LAYOUTS:
        before = fused_nuts_transition.launches
        got = nuts_step._launch(dens, q, inv_mass, 0.1, depth, 1000.0, (3, 4),
                                1, noise, shared)
        torch.cuda.synchronize()
        assert fused_nuts_transition.launches == before + 1
        _compare(got, want)
