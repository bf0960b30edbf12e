"""The layout rule of the whole-fit ADVI trainer (K11,
``zhusuan_tpu_torch/ops/advi_step.py::advi_layout``), on the CPU.

The kernel (``csrc/advi_step.cu``) spreads one fit's particle rows over the
blocks of one thread-block cluster: a lane a row at ``dim <= 4``, a warp a
row above. Here the rule is held to the kernel's limits (1-16 blocks, 1-16
warps, the shared memory of a block), and :func:`advi_rows`, the kernel's
row split written out, to covering every particle row exactly once, at
every width the kernel instantiates. Imports no jax; the kernel itself is
held to its plain version at every layout by the ``cuda`` tests of
``tests/test_torch_ops_advi_step.py``.
"""

import math

import pytest
import torch

from zhusuan_tpu_torch.ops import advi_step, densities

N_PARTICLES = (1, 3, 7, 33, 500, 3000)
# One width per instantiation and both ends of each: a lane a row at 1-4
# (D = dim), a warp a row with K = 1 (5-128), 2 (129-256), 4 (257-512).
DIMS = (1, 2, 3, 4, 5, 100, 128, 129, 256, 257, 512)
CASES = [(d, n) for d in DIMS for n in N_PARTICLES
         if advi_step.advi_step_supported(d, n, 10)]


def _covered_once(dim, n, cluster, warps):
    rows = [r for block in advi_step.advi_rows(dim, n, cluster, warps)
            for warp_rows in block for r in warp_rows]
    return sorted(rows) == list(range(n))


@pytest.mark.parametrize("dim,n", CASES)
def test_layout_is_valid_and_covers_every_row_once(dim, n):
    cluster, warps, mode = advi_step.advi_layout(dim, n)
    assert 1 <= cluster <= advi_step.MAX_CLUSTER == 16
    assert 1 <= warps <= advi_step.MAX_WARPS
    assert mode == ("lanes" if dim <= 4 else "warps")
    assert (advi_step.advi_shared_bytes(dim, cluster, warps)
            <= advi_step.SHARED_BYTES_LIMIT)
    assert _covered_once(dim, n, cluster, warps)


@pytest.mark.parametrize("cluster", range(1, 17))
@pytest.mark.parametrize("dim,n", [(2, 3), (2, 5), (2, 500), (100, 7),
                                   (100, 64), (37, 75)])
def test_every_cluster_size_covers_every_row_once(dim, n, cluster):
    """Rows fewer than blocks (n = 3, 5, 7), n not a multiple of the split:
    every row is still some warp's, once."""
    for warps in (1, 3, 4):
        assert _covered_once(dim, n, cluster, warps)


def test_rows_follow_the_kernels_order():
    # a lane a row: warp p of P takes the 32-row tiles p, p + P, ...
    rows = advi_step.advi_rows(2, 100, 2, 1)
    assert rows[0][0] == list(range(0, 32)) + list(range(64, 96))
    assert rows[1][0] == list(range(32, 64)) + list(range(96, 100))
    # a warp a row: warp p of P takes rows p, p + P, ...
    rows = advi_step.advi_rows(100, 10, 2, 2)
    assert rows[0] == [[0, 4, 8], [1, 5, 9]]
    assert rows[1] == [[2, 6], [3, 7]]


def test_shared_bytes_rule():
    # a lane a row: 2 buffers x cluster x warps x QP doubles (QP = 8 at 2)
    assert advi_step.advi_shared_bytes(2, 16, 1) == 8 * 2 * 16 * 8
    assert advi_step.advi_shared_bytes(4, 16, 2) == 8 * 2 * 32 * 16
    # a warp a row: (2 cluster + warps) rows of 2 (dim + 1) doubles, then
    # the replica's 6 vectors of 128 K floats
    assert (advi_step.advi_shared_bytes(100, 16, 4)
            == 8 * 202 * 36 + 4 * 6 * 128)
    assert (advi_step.advi_shared_bytes(512, 1, 1)
            == 8 * 1026 * 3 + 4 * 6 * 512)


def test_wide_fits_take_fewer_blocks():
    """At 512 columns 16 blocks' slots do not fit a block's shared memory:
    the rule takes fewer."""
    cluster, warps, _ = advi_step.advi_layout(512, 512)
    assert cluster < 16
    assert (advi_step.advi_shared_bytes(512, cluster, warps)
            <= advi_step.SHARED_BYTES_LIMIT)


@pytest.mark.parametrize("dim,n", [(0, 4), (513, 4), (4, 0)])
def test_layout_refuses_what_the_kernel_does_not_take(dim, n):
    with pytest.raises(ValueError, match="advi_layout takes"):
        advi_step.advi_layout(dim, n)


@pytest.mark.parametrize("layout", [(0, 1), (17, 1), (1, 0), (1, 17),
                                    (16, 16)])
def test_forced_layout_is_checked(layout):
    dens = densities.DiagonalGaussianLogJoint("z", torch.zeros(400),
                                              torch.ones(400))
    z = torch.zeros(400)
    with pytest.raises(ValueError, match="does not fit"):
        advi_step.fused_meanfield_advi(dens, z, z, 2, 4, (1, 2),
                                       lambda t: 0.1, _layout=layout)


def test_forced_layout_leaves_the_plain_version_alone():
    """On CPU tensors the layout is checked and the plain version runs:
    every layout gives the same fit."""
    dens = densities.Toy2DLogJoint("z")
    loc0, ls0 = torch.full((2,), -2.0), torch.full((2,), math.log(0.1))
    want = advi_step.fused_meanfield_advi(dens, loc0, ls0, 3, 40, (1, 2),
                                          lambda t: 0.1)
    for layout in ((1, 1), (2, 1), (16, 2)):
        got = advi_step.fused_meanfield_advi(dens, loc0, ls0, 3, 40, (1, 2),
                                             lambda t: 0.1, _layout=layout)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dim,n,want", [
    (2, 500, (4, 4)),     # toy2d recipe: a lane a row over 4 blocks
    (2, 40, (1, 2)),      # two tiles: one block
    (3, 3000, (12, 8)),   # a lane a row over 12 blocks of 8 warps
    (100, 64, (8, 8)),    # advi()'s Gaussian: a warp a row over 8 blocks
    (100, 32, (4, 8)),
    (100, 7, (1, 7)),     # fewer rows than a block's warps: one block
    (100, 200, (16, 8)),  # past 128 rows: two rows a warp
])
def test_rule_takes_the_measured_layouts(dim, n, want):
    """The layouts the H100 sweep measured fastest at these shapes
    (PERF_APPENDIX.md), or next to them where the sweep did not time the
    exact pair."""
    assert advi_step.advi_layout(dim, n)[:2] == want


@pytest.mark.parametrize("cluster", range(1, 17))
@pytest.mark.parametrize("dim,n", [(2, 3), (2, 500), (100, 7), (400, 21)])
def test_forced_cluster_sizes_fit(dim, n, cluster):
    warps = advi_step.advi_warps(dim, n, cluster)
    assert 1 <= warps <= advi_step.MAX_WARPS
    assert (advi_step.advi_shared_bytes(dim, cluster, warps)
            <= advi_step.SHARED_BYTES_LIMIT)
    assert _covered_once(dim, n, cluster, warps)
