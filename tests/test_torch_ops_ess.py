"""The one-pass ESS kernel (``zhusuan_tpu_torch/ops/ess.py``,
``csrc/ess.cu``) on the card, held to the float64 estimator on the host
(:func:`zhusuan_tpu_torch.diagnostics.ess_batch`) on the same values.

Imports no jax; every test needs the card:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_ess.py``.

The columns: AR(1) chains with phi from -0.5 to 0.995, a frozen column
(ESS 0), a column holding an infinity (ESS 0: its acov(0) is NaN) and a
random walk, whose first negative rho comes tens of lags out. A column
whose rho never turns negative does not exist: the autocovariances
weighted by their counts, ``sum_{t >= 1} (n - t) acov(t)``, sum to
``-n acov(0) / 2``, so the lag loop always stops before ``n``.

Tolerances: the kernel sums products of centred float32 values in float32
in another order than the float64 FFT; the worst column (phi near 1,
n = 500) is about 1e-6 off, so 1e-5 per column, and 1e-6 on a job's
total (each chain's minimum over dimensions, summed), where the columns'
errors average out.
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch.diagnostics import (
    _batched_reference_acov,
    ess_batch,
    ess_batch_device,
)
from zhusuan_tpu_torch.ops.ess import ess_layout, fused_ess


def _max_rows():
    n = 2
    while ess_layout(n + 1, 1, torch.float32) is not None:
        n += 1
    return n


ROWS = [2, 3, 100, 300, 500, _max_rows()]
DTYPES = [torch.float32, torch.bfloat16]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _ar1(rng, n, phis):
    """``[n, len(phis)]`` stationary AR(1) chains, unit innovations."""
    phis = np.asarray(phis, dtype=np.float64)
    e = rng.standard_normal((n, phis.size))
    x = np.empty_like(e)
    x[0] = e[0] / np.sqrt(1.0 - phis ** 2)
    for i in range(1, n):
        x[i] = phis * x[i - 1] + e[i]
    return x


def _columns(n, seed=0):
    """``[n, 46]``: 43 AR(1) columns, a frozen one, one with an infinity,
    a random walk (46 columns: a tile and a ragged one, 4-byte loads)."""
    rng = np.random.default_rng(seed)
    frozen = np.full((n, 1), 1.5)
    spoiled = rng.standard_normal((n, 1))
    spoiled[n // 2] = np.inf
    walk = np.cumsum(rng.standard_normal((n, 1)), axis=0)
    return np.concatenate([_ar1(rng, n, np.linspace(-0.5, 0.995, 43)),
                           frozen, spoiled, walk], axis=1)


def _reference(draws):
    """The float64 estimator on the host, on the values the card holds."""
    return ess_batch(draws.cpu().to(torch.float64)).numpy()


def _cutoff(column):
    """The lag of the first negative rho of a ``[n]`` float64 column."""
    n = column.shape[0]
    acov = _batched_reference_acov(column[:, None])[:, 0]
    rho = acov / acov[0] - 1.0 / (n - 1)
    return int(torch.nonzero(rho < 0)[0])


def _kernel(draws):
    before = fused_ess.launches
    got = fused_ess(draws)
    torch.cuda.synchronize()
    assert fused_ess.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (draws.shape[1],)
    return got.cpu().numpy().astype(np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_matches_the_float64_estimator(dtype, n):
    dev = _cuda()
    draws = torch.from_numpy(_columns(n)).to(dev, dtype)
    got = _kernel(draws)
    want = _reference(draws)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[43] == 0.0 and got[44] == 0.0  # frozen, infinity
    if n >= 100:  # the walk runs past the first pass of 8 lags
        assert _cutoff(draws[:, 45].cpu().to(torch.float64)) > 8


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 300, 500])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_job_total_matches(dtype, n):
    """A job's ESS as the benchmark reads it: ``[n, chains * dims]`` (61
    chains of 12 dimensions: 732 columns, 16-byte or 8-byte loads, a ragged
    last tile), each chain's minimum over dimensions, summed."""
    dev = _cuda()
    rng = np.random.default_rng(n)
    chains, dims = 61, 12
    phis = np.tile(np.linspace(0.0, 0.98, dims), chains)
    draws = torch.from_numpy(_ar1(rng, n, phis)).to(dev, dtype)
    got = _kernel(draws)
    want = _reference(draws)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    total = got.reshape(chains, dims).min(axis=1).sum()
    ref_total = want.reshape(chains, dims).min(axis=1).sum()
    assert abs(total - ref_total) <= 1e-6 * ref_total


@pytest.mark.cuda
def test_float16_and_offset_views():
    """float16 draws, and views read in place: one that starts off the
    loads' alignment (row stride 47), and one whose rows are 48 apart and
    44 long (the vector loads at a row stride past the row)."""
    dev = _cuda()
    base = torch.from_numpy(_columns(300, seed=3)).to(dev)
    half = base.to(torch.float16)
    np.testing.assert_allclose(_kernel(half), _reference(half), rtol=1e-5,
                               atol=0)
    wide = torch.cat([base[:, :1], base], dim=1).to(torch.float32)[:, 1:]
    assert wide.stride() == (47, 1)
    np.testing.assert_allclose(_kernel(wide), _reference(base.float()),
                               rtol=1e-5, atol=0)
    for dtype in DTYPES:
        padded = torch.cat([base, base[:, :2]], dim=1).to(dtype)[:, 4:48]
        assert padded.stride() == (48, 1)
        np.testing.assert_allclose(_kernel(padded), _reference(padded),
                                   rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_ess_batch_device_routes_by_what_it_sees():
    """On the card a float32 or bfloat16 tensor goes to the kernel in one
    launch; float64, one row, rows past the layout and strided columns take
    the FFT."""
    dev = _cuda()
    draws = torch.from_numpy(_columns(200, seed=5)).to(dev)
    for dtype in DTYPES:
        x = draws.to(dtype)
        before = fused_ess.launches
        got = ess_batch_device(x)
        assert fused_ess.launches == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), _reference(x),
                                   rtol=1e-5, atol=0)
    before = fused_ess.launches
    got64 = ess_batch_device(draws)
    one = ess_batch_device(draws[:1].float())
    strided = draws.float().t().contiguous().t()  # columns 200 apart
    got_strided = ess_batch_device(strided)
    long = torch.from_numpy(
        _ar1(np.random.default_rng(9), _max_rows() + 1, [0.3, 0.6])).to(
            dev, torch.float32)
    got_long = ess_batch_device(long)
    assert fused_ess.launches == before
    assert got64.dtype == torch.float64 and one.shape == (46,)
    np.testing.assert_allclose(got64.cpu().numpy(), _reference(draws),
                               rtol=1e-9)
    np.testing.assert_allclose(got_long.cpu().numpy(), _reference(long),
                               rtol=1e-4)
    np.testing.assert_allclose(got_strided.cpu().numpy(),
                               _reference(strided), rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_the_layout_refuses():
    dev = _cuda()
    with pytest.raises(ValueError):
        fused_ess(torch.zeros((4, 3), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        fused_ess(torch.zeros((1, 3), device=dev))
    with pytest.raises(ValueError):
        fused_ess(torch.zeros((3, 4), device=dev).t())
    before = fused_ess.launches
    with pytest.raises(ValueError):
        fused_ess(torch.zeros((4, 3)))
    assert fused_ess.launches == before
