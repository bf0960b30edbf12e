"""Parity tests of zhusuan_tpu_torch.diagnostics against the JAX package.

Inputs are AUTOCORRELATED AR(1) chains (rho = 0.9): on iid input the
reference estimator sits at a data-independent fixed point, n/(3 - 2/(n-1)),
so a parity test there would pass for any implementation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu.diagnostics as jdiag
import zhusuan_tpu_torch.diagnostics as tdiag

torch.set_num_threads(1)

N, RHO = 200, 0.9


def _ar1(n_cols, seed=0):
    rs = np.random.RandomState(seed)
    noise = rs.randn(N, n_cols)
    x = np.empty_like(noise)
    x[0] = noise[0] / np.sqrt(1 - RHO ** 2)
    for i in range(1, N):
        x[i] = RHO * x[i - 1] + noise[i]
    return x


def test_ar1_is_not_at_the_iid_fixed_point():
    ess = np.asarray(jdiag.ess_batch(_ar1(16)))
    fixed_point = N / (3 - 2 / (N - 1))
    assert np.all(ess < 0.5 * fixed_point)
    assert np.ptp(ess) > 1.0


def test_ess_batch_matches_jax():
    x = _ar1(16, 1)
    x[:, 3] = 2.5  # a frozen column: ESS 0 in both
    want = np.asarray(jdiag.ess_batch(x))
    got = tdiag.ess_batch(torch.as_tensor(x))
    assert got.dtype == torch.float64 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8)
    assert got[3] == 0.0
    # Trailing axes are flattened, as in the JAX version.
    got3 = tdiag.ess_batch(torch.as_tensor(x.reshape(N, 4, 4)))
    np.testing.assert_allclose(got3.numpy(), want, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("chunk", [1 << 18, 5])
def test_ess_batch_device_float64_matches_jax_host_estimator(chunk):
    x = _ar1(16, 2)
    want = np.asarray(jdiag.ess_batch(x))
    got = tdiag.ess_batch_device(torch.as_tensor(x), chunk=chunk)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8)


def test_ess_batch_device_float32_matches_jax_device_estimator():
    """Both compute in float32 here; the sums run in another order, so the
    tolerance is float32's."""
    x = _ar1(32, 3).astype(np.float32)
    want = np.asarray(jdiag.ess_batch_device(jnp.asarray(x)))
    got = tdiag.ess_batch_device(torch.as_tensor(x), chunk=7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_ess_batch_device_upcasts_bf16_per_chunk():
    x = torch.as_tensor(_ar1(8, 4)).to(torch.bfloat16)
    got = tdiag.ess_batch_device(x, chunk=3)
    want = tdiag.ess_batch_device(x.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want)


def test_effective_sample_size_matches_jax():
    x = _ar1(6, 5)
    for burn_in in (0, 20):
        np.testing.assert_allclose(
            tdiag.effective_sample_size(torch.as_tensor(x), burn_in),
            jdiag.effective_sample_size(x, burn_in), rtol=1e-8)
    col = x[:, 0]
    np.testing.assert_allclose(
        tdiag.effective_sample_size_1d(torch.as_tensor(col)),
        jdiag.effective_sample_size_1d(col), rtol=1e-8)
    frozen = np.ones((50, 3))
    assert tdiag.effective_sample_size(frozen, 0) == \
        jdiag.effective_sample_size(frozen, 0) == np.inf
