"""MCMC diagnostics: effective sample size (port of
``zhusuan_tpu/diagnostics.py``).

Capability parity with reference ``zhusuan/diagnostics.py``:
``effective_sample_size_1d`` (diagnostics.py:17-40) and
``effective_sample_size`` (diagnostics.py:43-64, min over dimensions).

The reference estimator, kept exactly: with ``mu = mean(x)``,
``var = var(x) * n/(n-1)``, ``var_plus = var(x)`` and
``acov(t) = mean((x[:n-t]-mu)*(x[t:]-mu))`` (1/(n-t) normalisation),
accumulate ``rho_t = 1 - (var - acov(t)) / var_plus`` from t=0 upward until
the first negative value, then ``ess = n / (1 + 2 * sum_rho)``. The per-lag
loop becomes one batched FFT autocovariance (``torch.fft``) over all
columns.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "effective_sample_size",
    "effective_sample_size_1d",
    "ess_batch",
    "ess_batch_device",
]


def _batched_reference_acov(x):
    """Reference-style autocovariance for all lags of ``x [n, d]``:
    ``acov[t] = (1/(n-t)) * sum_i (x[i]-mu)(x[i+t]-mu)`` (parity with
    reference diagnostics.py:29-30)."""
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    m = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(xc, n=m, dim=0)
    raw = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    counts = (n - torch.arange(n, device=x.device, dtype=x.dtype))[:, None]
    return raw / counts


def _ess_from_acov(acov, n: int):
    """Vectorised reference recurrence: ``acov [n, d] -> ess [d]``.

    A zero-variance (frozen) column gets ESS 0: a constant chain carries no
    information about mixing."""
    var_plus = acov[0]
    var = acov[0] * n / (n - 1)
    safe = torch.where(var_plus == 0, torch.ones_like(var_plus), var_plus)
    rho = 1.0 - (var - acov) / safe
    rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
    neg = rho < 0
    any_neg = neg.any(dim=0)
    first_neg = torch.argmax(neg.to(torch.uint8), dim=0)
    cutoff = torch.where(any_neg, first_neg, torch.full_like(first_neg, n))
    lag_idx = torch.arange(n, device=acov.device)[:, None]
    sum_rho = torch.sum(
        torch.where(lag_idx < cutoff, rho, torch.zeros_like(rho)), dim=0)
    ess = n / (1.0 + 2.0 * sum_rho)
    return torch.where(var_plus > 0, ess, torch.zeros_like(ess))


def effective_sample_size_1d(samples) -> float:
    """ESS of a 1-D chain of scalar samples (reference diagnostics.py:17-40,
    identical estimator, FFT accelerated)."""
    x = torch.as_tensor(samples).detach().to("cpu", torch.float64)
    n = x.shape[0]
    return float(_ess_from_acov(_batched_reference_acov(x[:, None]), n)[0])


def ess_batch(samples):
    """Per-column ESS of ``[n, ...]`` samples (trailing axes flattened) on
    the host in float64 -> float64 CPU tensor ``[d]``."""
    x = torch.as_tensor(samples).detach().to("cpu", torch.float64)
    n = x.shape[0]
    return _ess_from_acov(_batched_reference_acov(x.reshape(n, -1)), n)


def ess_batch_device(samples, chunk: int = 1 << 18):
    """Per-column ESS of ``[n, d]`` samples on their own device.

    Same estimator as :func:`ess_batch`, chunked over columns to bound
    device memory; each chunk is upcast on its own (a bfloat16 trajectory
    is never copied whole to float32) to at least float32 (float64 input
    stays float64). Returns a ``[d]`` tensor on the input's device.
    """
    samples = torch.as_tensor(samples)
    n, d = samples.shape
    dtype = torch.promote_types(samples.dtype, torch.float32)
    out = []
    for start in range(0, d, chunk):
        x = samples[:, start:start + chunk].to(dtype)
        out.append(_ess_from_acov(_batched_reference_acov(x), n))
    return torch.cat(out)


def effective_sample_size(samples, burn_in: int = 100) -> float:
    """Minimum positive ESS across dimensions after discarding ``burn_in``
    (reference diagnostics.py:43-64, which ignores zero-ESS dimensions).

    :param samples: ``[n_iters, d]`` (or any trailing shape, flattened),
        iterations first.
    """
    x = torch.as_tensor(samples).detach().to("cpu", torch.float64)[burn_in:]
    esses = ess_batch(x.reshape(x.shape[0], -1))
    positive = esses[esses > 0]
    if positive.numel() == 0:
        return math.inf
    return float(positive.min())
