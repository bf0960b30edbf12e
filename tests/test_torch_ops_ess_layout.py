"""The one-pass ESS kernel's layout and route (``zhusuan_tpu_torch/ops/
ess.py``), on the CPU.

:func:`ess_layout` routes by ``csrc/ess.cu``'s shared-memory rule: the
rule held here to a block's 227 KB for every dtype and row count the layout
takes, and None past them. :func:`diagnostics.ess_batch_device` sends only
CUDA tensors that the layout takes to the kernel: CPU tensors, float64 and
a single row keep the FFT path and its outputs, and launch nothing; the
wrapper itself refuses a CPU tensor. Imports no jax; the kernel
itself is held to the float64 estimator by the ``cuda`` tests of
``tests/test_torch_ops_ess.py``.
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch import diagnostics
from zhusuan_tpu_torch.ops import ess

SHARED_MAX = 232448  # a block's dynamic shared memory on an H100
KERNEL_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _limit(dtype):
    n = 2
    while ess.ess_layout(n + 1, 1, dtype) is not None:
        n += 1
    return n


def _shared_bytes(n, warps):
    """``csrc/ess.cu``'s dynamic shared memory for a block: ``n + 8``
    staged rows of 33 floats (32 columns and a pad), the warps' 8 partial
    sums a column, 3 floats a column and 2 counters."""
    return 4 * ((n + 8) * 33 + warps * 8 * 32 + 3 * 32 + 2)


@pytest.mark.parametrize("dtype", KERNEL_DTYPES, ids=str)
def test_layout_fits_a_block_up_to_its_limit(dtype):
    limit = _limit(dtype)
    assert limit >= 1024  # the cells' 100-500 rows, with room
    for n in range(2, limit + 1):
        warps = ess.ess_layout(n, 3276800, dtype)
        assert warps == min(8, -(-n // 32))  # a warp for each 32 rows
        assert _shared_bytes(n, warps) <= SHARED_MAX
    # The limit is where the next row no longer fits.
    assert _shared_bytes(limit + 1, 8) > SHARED_MAX
    assert ess.ess_layout(limit + 1, 1, dtype) is None
    assert ess.ess_layout(limit + 1000, 1, dtype) is None


@pytest.mark.parametrize("n, cols, dtype", [
    (1, 100, torch.float32),
    (0, 100, torch.float32),
    (300, 0, torch.float32),
    (300, 100, torch.float64),
    (300, 100, torch.int32),
    (300, 100, torch.complex64),
])
def test_layout_refuses(n, cols, dtype):
    assert ess.ess_layout(n, cols, dtype) is None


def test_layout_is_the_same_for_every_dtype_it_takes():
    """The tile is widened to float32 on the way in: 16-bit draws stage
    the same bytes as float32."""
    for n in (2, 100, 300, 500):
        layouts = {ess.ess_layout(n, 64, d) for d in KERNEL_DTYPES}
        assert len(layouts) == 1


def _fft(x):
    """The FFT estimator on one chunk, outside the router."""
    n = x.shape[0]
    dtype = torch.promote_types(x.dtype, torch.float32)
    return diagnostics._ess_from_acov(
        diagnostics._batched_reference_acov(x.to(dtype)), n)


def _draws(n, cols, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cols))
    x[1:] += 0.7 * x[:-1]  # some autocorrelation
    return torch.from_numpy(x)


@pytest.mark.parametrize("n, dtype", [
    (300, torch.float32),
    (300, torch.bfloat16),
    (300, torch.float16),
    (300, torch.float64),
    (2, torch.float32),
    (1, torch.float32),
    (1, torch.float64),
])
def test_cpu_tensors_never_reach_the_kernel(n, dtype):
    x = _draws(n, 37).to(dtype)
    before = ess.fused_ess.launches
    got = diagnostics.ess_batch_device(x)
    assert ess.fused_ess.launches == before
    want = _fft(x)
    assert got.dtype == want.dtype and got.shape == (37,)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_chunks_keep_their_meaning_on_the_fft_path():
    x = _draws(50, 70, seed=1).to(torch.float32)
    before = ess.fused_ess.launches
    want = torch.cat([_fft(x[:, i:i + 16]) for i in range(0, 70, 16)])
    torch.testing.assert_close(diagnostics.ess_batch_device(x, chunk=16),
                               want, rtol=0, atol=0)
    assert ess.fused_ess.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ess_refuses_cpu_tensors(dtype):
    """The wrapper is the card's alone: a CPU tensor raises and launches
    nothing (``ess_batch_device`` keeps it on the FFT path)."""
    x = _draws(200, 40, seed=2).to(dtype)
    before = ess.fused_ess.launches
    with pytest.raises(ValueError):
        ess.fused_ess(x)
    assert ess.fused_ess.launches == before


def test_fused_ess_takes_two_dimensional_draws():
    with pytest.raises(ValueError):
        ess.fused_ess(torch.zeros(10))
