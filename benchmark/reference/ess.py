"""Effective sample size of each column of ``[n, m]`` draws, in float64.

The estimator the check returns (Geyer's initial positive sequence in its
simplest form, as in the original ZhuSuan diagnostics): with ``mu`` the
column mean, ``acov(t) = sum_i (x_i - mu)(x_{i+t} - mu) / (n - t)``,
``var+ = acov(0)`` and ``var = acov(0) n / (n - 1)``, sum
``rho_t = 1 - (var - acov(t)) / var+`` from ``t = 0`` up to the first
negative value, and ``ess = n / (1 + 2 sum rho)``; a constant column has
ESS 0. The autocovariances come from one zero-padded FFT per block of
columns.
"""

from __future__ import annotations

import math

import torch


def _block(x, dtype):
    """The estimator over the columns of ``x`` in ``dtype``; an FFT in a
    precision torch has no FFT for runs in float32 on values rounded to
    ``dtype``."""
    n = x.shape[0]
    x = x.to(dtype)
    xc = x - x.mean(dim=0, keepdim=True)
    fft_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    size = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(xc.to(fft_dtype), n=size, dim=0)
    raw = torch.fft.irfft(f * f.conj(), n=size, dim=0)[:n].to(dtype)
    acov = raw / (n - torch.arange(n, dtype=dtype, device=x.device))[:, None]
    var_plus = acov[0]
    safe = torch.where(var_plus == 0, torch.ones_like(var_plus), var_plus)
    rho = 1.0 - (acov[0] * n / (n - 1) - acov) / safe
    rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, -1.0))
    negative = rho < 0
    first = torch.where(negative.any(dim=0),
                        negative.to(torch.uint8).argmax(dim=0),
                        torch.full_like(var_plus, n, dtype=torch.int64))
    lags = torch.arange(n, device=x.device)[:, None]
    total = torch.where(lags < first, rho, torch.zeros_like(rho)).sum(dim=0)
    ess = n / (1.0 + 2.0 * total)
    return torch.where(var_plus > 0, ess, torch.zeros_like(ess))


def ess_columns(draws, block: int = 1 << 16, dtype=torch.float64):
    """ESS ``[m]`` of the columns of ``draws [n, m]`` (any float dtype,
    read a block of columns at a time), computed in ``dtype``."""
    n, m = draws.shape
    out = torch.empty(m, dtype=torch.float64, device=draws.device)
    for start in range(0, m, block):
        out[start:start + block] = _block(draws[:, start:start + block],
                                          dtype)
    return out


def ess_total(draws, n_chains: int, dtype=torch.float64) -> float:
    """A job's ESS, computed in ``dtype``: each chain's minimum over
    dimensions, summed over chains."""
    n = draws.shape[0]
    ess = ess_columns(draws.reshape(n, -1), dtype=dtype)
    return float(ess.reshape(n_chains, -1).min(dim=1).values.sum())


def ess_gap(draws, answer: float, n_chains: int) -> float:
    """``|answer / reference - 1|`` of a job's ESS, the reference computed
    in float64 over the same draws."""
    ref = ess_total(draws, n_chains)
    gap = abs(float(answer) / ref - 1.0) if ref else math.inf
    return gap if math.isfinite(gap) else math.inf
