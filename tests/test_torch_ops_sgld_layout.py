"""The SGLD kernel's two bodies (K3, ``zhusuan_tpu_torch/ops/sgld_step.py``),
on the CPU.

On the diagonal density at ``dim % 4 == 0`` the kernel takes a flat pass (a
thread a group of 4 elements, 16-byte loads and stores), elsewhere the warp
body it shares with PSGLD, SGHMC and SGNHT. Here :func:`sgld_layout` is
held to that rule, and the flat pass's index map (``sgld_flat_groups``,
flat group -> (chain, group)) to drawing, through the torch Philox, the
very numbers ``ops/_random.py`` gives the warp body and the plain version.
Imports no jax; the kernel is held to its plain version on both bodies by
the ``cuda`` tests of ``tests/test_torch_ops_sgmcmc_step.py``.
"""

import pytest
import torch

from zhusuan_tpu_torch.ops import _random
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)
from zhusuan_tpu_torch.ops.sgld_step import (
    fused_sgld_step,
    sgld_flat_groups,
    sgld_layout,
)

KEY = (0x12345678, 0x9ABCDEF0)


def _density(kind, d):
    if kind == "diagonal":
        return DiagonalGaussianLogJoint("x", torch.zeros(d),
                                        torch.linspace(0.1, 1.0, d))
    return EquicorrelatedGaussianLogJoint("x", d, 0.9)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 37, 99, 100, 128, 510, 512])
@pytest.mark.parametrize("kind", ["diagonal", "equicorrelated"])
def test_flat_only_on_the_diagonal_density_at_whole_groups(kind, d):
    want = "flat" if kind == "diagonal" and d % 4 == 0 else "warp"
    assert sgld_layout(_density(kind, d), d) == want


def _flat_normals(key, t, c, d):
    """The flat body's draws in torch: flat group i -> (chain, grp) ->
    Philox (t, chain, grp, STREAM_SGMCMC_NOISE) -> Box-Muller on words
    (0, 1) and (2, 3) -> elements 4 i .. 4 i + 3 of the flattened state."""
    chain, grp = sgld_flat_groups(c, d)
    words = _random.philox4x32_10(
        torch.full_like(chain, t), chain, grp,
        torch.full_like(chain, _random.STREAM_SGMCMC_NOISE), *key)
    n0, n1 = _random.split_boxmuller_normal(words[0], words[1])
    n2, n3 = _random.split_boxmuller_normal(words[2], words[3])
    return torch.stack([n0, n1, n2, n3], -1).reshape(c, d)


@pytest.mark.parametrize("t", [0, 7])
@pytest.mark.parametrize("shape", [(33, 100), (5, 8)])
def test_flat_index_map_reproduces_the_philox_draws(shape, t):
    c, d = shape
    got = _flat_normals(KEY, t, c, d)
    want = _random.philox_normal(KEY, t, (c, d),
                                 _random.STREAM_SGMCMC_NOISE)
    assert torch.equal(got, want)


def test_flat_index_map():
    chain, grp = sgld_flat_groups(3, 8)
    assert chain.tolist() == [0, 0, 1, 1, 2, 2]
    assert grp.tolist() == [0, 1, 0, 1, 0, 1]


@pytest.mark.parametrize("path", [None, "warp"])
def test_cpu_wrapper_takes_the_plain_version_on_either_path(path):
    """On CPU tensors both bodies are the plain version: the forced path
    changes nothing and counts no launch."""
    dens = _density("diagonal", 8)
    q = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    before = fused_sgld_step.launches
    got = fused_sgld_step(dens, q, 0.01, KEY, 3, _path=path)
    want = fused_sgld_step(dens, q, 0.01, KEY, 3)
    assert torch.equal(got, want)
    assert fused_sgld_step.launches == before
