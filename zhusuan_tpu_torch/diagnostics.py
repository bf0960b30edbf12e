"""MCMC diagnostics (port of ``zhusuan_tpu/diagnostics.py``): effective
sample size, split / rank-normalized / nested R-hat, the per-latent
``summary`` table and the kernelized Stein discrepancy.

Capability parity with reference ``zhusuan/diagnostics.py``:
``effective_sample_size_1d`` (diagnostics.py:17-40) and
``effective_sample_size`` (diagnostics.py:43-64, min over dimensions).

The reference estimator, kept exactly: with ``mu = mean(x)``,
``var = var(x) * n/(n-1)``, ``var_plus = var(x)`` and
``acov(t) = mean((x[:n-t]-mu)*(x[t:]-mu))`` (1/(n-t) normalisation),
accumulate ``rho_t = 1 - (var - acov(t)) / var_plus`` from t=0 upward until
the first negative value, then ``ess = n / (1 + 2 * sum_rho)``. The per-lag
loop becomes one batched FFT autocovariance (``torch.fft``) over all
columns; on the card, :func:`ess_batch_device` takes float32, bfloat16 and
float16 draws to one hand-written kernel instead
(:func:`~zhusuan_tpu_torch.ops.ess.fused_ess`), which reads them once.

The JAX package computes R-hat, ``summary`` and the ranks on the host with
numpy in float64. The port computes them in float64 on the draws' own
device, a few columns of the data axes at a time (:data:`CHUNK_ELEMENTS`
float64 values a chunk), so a ``[500, 32768, 100]`` bfloat16 trajectory
(3.3 GB) is never copied whole to float64 (13 GB) nor to the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from zhusuan_tpu_torch.ops.ess import ess_layout, fused_ess

__all__ = [
    "effective_sample_size",
    "effective_sample_size_1d",
    "ess_batch",
    "ess_batch_device",
    "nested_rhat",
    "potential_scale_reduction",
    "summary",
    "kernel_stein_discrepancy",
]

#: float64 values of one column chunk of R-hat and ``summary`` (2^25: 256
#: MB); a ``[500, 32768]`` column takes 16.4M.
CHUNK_ELEMENTS = 1 << 25


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

    Same estimator as :func:`ess_batch`. A CUDA tensor with contiguous
    columns that :func:`~zhusuan_tpu_torch.ops.ess.ess_layout` takes
    (float32, bfloat16 or float16, ``n >= 2``, ``n`` within the kernel's
    shared memory) goes to the kernel
    :func:`~zhusuan_tpu_torch.ops.ess.fused_ess` in one launch, in float32,
    read in place whatever its row stride. Anything else takes the batched
    FFT, chunked over ``chunk`` columns to bound device memory; each chunk
    is upcast on its own to at least float32 (float64 input stays
    float64). Neither path copies a trajectory whole. Returns a ``[d]``
    tensor on the input's device.
    """
    samples = torch.as_tensor(samples)
    n, d = samples.shape
    if (samples.is_cuda and (d == 1 or samples.stride(1) == 1)
            and ess_layout(n, d, samples.dtype) is not None):
        return fused_ess(samples)
    return _ess_fft(samples, chunk)


def _ess_fft(samples, chunk: int = 1 << 18):
    """:func:`ess_batch_device`'s FFT path: the estimator over ``chunk``
    columns at a time, each chunk upcast to at least float32."""
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


# --------------------------------------------------------------------- #
# R-hat, summary and KSD (JAX diagnostics.py:38-194, 329-479)            #
# --------------------------------------------------------------------- #
def _draws(samples, name="samples"):
    x = torch.as_tensor(samples)
    if x.ndim < 2:
        raise ValueError(
            "{} must be [n_iters, n_chains, ...]; got shape {}.".format(
                name, tuple(x.shape)))
    return x


def _column_chunks(x):
    """``x [n, m, ...]`` as ``[n, m, K]`` and the column slices of chunks
    of at most :data:`CHUNK_ELEMENTS` values."""
    n, m = x.shape[:2]
    flat = x.reshape(n, m, -1)
    k = flat.shape[-1]
    step = max(1, CHUNK_ELEMENTS // max(1, n * m))
    return flat, [slice(i, min(i + step, k)) for i in range(0, k, step)]


def _sorted_columns(flat):
    """Stable sort of every column of ``flat [N, c]``, a contiguous row a
    column: ``(values, order)``, each ``[c, N]``."""
    return torch.sort(flat.t().contiguous(), dim=1, stable=True)


def _median_of_sorted(sv):
    """numpy's median of each row of sorted ``sv [c, N]``: the average of
    the two middle values for an even ``N`` (``torch.median`` would give
    the lower one)."""
    n = sv.shape[1]
    if n % 2:
        return sv[:, n // 2]
    return 0.5 * (sv[:, n // 2 - 1] + sv[:, n // 2])


def _rank_scores(flat, sorted_cols=None):
    """Normal scores of the AVERAGE fractional ranks of every column of
    ``flat [N, c]`` (Vehtari et al. 2021, Eq. 14: Blom offsets, then the
    normal PPF). Ties share one rank: a tie group is a run of equal values
    in sorted order and takes ``(first + last) / 2`` of its positions (JAX
    ``diagnostics.py:48-70``); ordinal ranks would fabricate R-hat ~1.5 on
    constant latents. The runs come from ``unique_consecutive`` on each
    sorted column (a 1-D pass; a running max down a ``[N, c]`` column would
    be one sequential thread a column on the card)."""
    n_tot = flat.shape[0]
    sv, order = sorted_cols if sorted_cols is not None else \
        _sorted_columns(flat)
    ranks = torch.empty_like(sv)
    for j in range(sv.shape[0]):
        _, counts = torch.unique_consecutive(sv[j], return_counts=True)
        ends = torch.cumsum(counts, 0)
        avg = 0.5 * ((ends - counts) + (ends - 1)).to(flat.dtype)
        ranks[j].scatter_(0, order[j],
                          torch.repeat_interleave(avg, counts))
    return torch.special.ndtri((ranks.t() + 1 - 0.375) / (n_tot + 0.25))


def _rank_normalize(x):
    """Rank-normal scores of ``x [n, m, ...]`` pooled over ``(n, m)``, per
    column, in float64 on ``x``'s device (JAX ``diagnostics.py:38-73``)."""
    x = torch.as_tensor(x)
    n, m = x.shape[:2]
    flat = x.reshape(n * m, -1).to(torch.float64)
    return _rank_scores(flat).reshape(x.shape)


def _bulk_and_folded(x):
    """The rank-normalized bulk scores and the scores of the folded draws
    ``|x - median|`` of a float64 chunk ``x [n, m, c]``."""
    n, m, c = x.shape
    flat = x.reshape(n * m, c)
    sorted_cols = _sorted_columns(flat)
    bulk = _rank_scores(flat, sorted_cols).reshape(n, m, c)
    med = _median_of_sorted(sorted_cols[0])
    folded = _rank_scores(torch.abs(flat - med)).reshape(n, m, c)
    return bulk, folded


def _split_rhat(x):
    """Split-R-hat of a float64 ``[n, m, c]`` chunk (JAX :101-120)."""
    n = x.shape[0]
    half = n // 2
    x = torch.cat([x[:half], x[half:2 * half]], dim=1)
    n = x.shape[0]
    chain_means = x.mean(dim=0)
    chain_vars = x.var(dim=0, correction=1)
    w = chain_vars.mean(dim=0)
    b = n * chain_means.var(dim=0, correction=1)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / w)


def _nested_rhat(x, k):
    """Nested R-hat of a float64 ``[n, c_chains, c]`` chunk with ``k``
    superchains (JAX :181-194)."""
    n, c = x.shape[:2]
    x = x.reshape((n, k, c // k) + tuple(x.shape[2:]))
    chain_means = x.mean(dim=0)
    within_chain = x.var(dim=0, correction=0)
    super_means = chain_means.mean(dim=1)
    between_chain = torch.mean((chain_means - super_means[:, None]) ** 2,
                               dim=1)
    w = torch.mean(between_chain + within_chain.mean(dim=1), dim=0)
    b = super_means.var(dim=0, correction=1)
    return torch.sqrt(1.0 + b / w)


def _rhat_fn(n, m, n_superchains):
    """The chunk statistic of R-hat for ``n`` draws of ``m`` chains: nested
    with ``n_superchains`` superchains, else split; raises on arguments
    that leave it undefined."""
    if n_superchains is not None:
        k = int(n_superchains)
        if k < 2:
            raise ValueError("n_superchains must be >= 2.")
        if m % k != 0:
            raise ValueError(
                "n_superchains ({}) must divide n_chains ({}).".format(k, m))
        return lambda xc: _nested_rhat(xc, k)
    if n < 2:
        raise ValueError(
            "split-R-hat needs n_iters >= 2 to estimate within-chain "
            "variance (got {}); for single-draw many-chain runs use "
            "nested_rhat.".format(n))
    return _split_rhat


def _chunked(x, fn, rank_normalized):
    """``fn`` over the column chunks of ``x [n, m, ...]`` in float64; with
    ``rank_normalized`` the max of ``fn`` on the bulk and folded scores.
    Returns a float64 tensor of shape ``x.shape[2:]`` on ``x``'s device."""
    flat, chunks = _column_chunks(x)
    out = []
    for cols in chunks:
        xc = flat[:, :, cols].to(torch.float64)
        if rank_normalized:
            bulk, folded = _bulk_and_folded(xc)
            out.append(torch.maximum(fn(bulk), fn(folded)))
        else:
            out.append(fn(xc))
    return torch.cat(out).reshape(x.shape[2:])


def potential_scale_reduction(samples, rank_normalized: bool = False):
    """Split-R-hat (Gelman-Rubin potential scale reduction) per dimension
    (JAX ``diagnostics.py:76-120``; beyond the reference, whose only
    diagnostic is ESS). Values near 1.0 indicate convergence; > 1.01 is
    suspect.

    :param samples: ``[n_iters, n_chains, ...]`` (each chain's draws along
        axis 0), a tensor (any float dtype, any device) or an array.
    :param rank_normalized: the rank-normalized R-hat of Vehtari et al.
        2021: the max of the bulk statistic (rank-normal scores) and the
        folded one (scores of ``|x - median|``, which catches chains that
        agree in location but differ in scale).
    :return: float64 tensor of shape ``samples.shape[2:]`` on the draws'
        device.
    """
    x = _draws(samples)
    return _chunked(x, _rhat_fn(x.shape[0], x.shape[1], None),
                    rank_normalized)


def nested_rhat(samples, n_superchains: int, rank_normalized: bool = False):
    """Nested R-hat for many short chains (Margossian et al., Bayesian
    Analysis 2024; JAX ``diagnostics.py:123-194``): chains grouped
    contiguously into ``n_superchains`` superchains,
    ``sqrt(1 + B / W)`` with ``B`` the ddof-1 variance of the superchain
    means and ``W`` the mean over superchains of the between-chain plus
    the biased within-chain variance. Defined at one draw a chain.

    :param samples: ``[n_iters, n_chains, ...]``; ``n_iters`` may be 1.
    :param n_superchains: K >= 2, dividing ``n_chains``.
    :param rank_normalized: as in :func:`potential_scale_reduction`.
    :return: float64 tensor of shape ``samples.shape[2:]`` on the draws'
        device.
    """
    x = _draws(samples)
    return _chunked(x, _rhat_fn(x.shape[0], x.shape[1], int(n_superchains)),
                    rank_normalized)


def summary(samples, round_to: int = 3, rank_normalized: bool = False,
            n_superchains: Optional[int] = None):
    """Per-latent posterior mean / sd, R-hat and ESS in one call, over the
    ``outputs["samples"]`` of a sampler's ``run`` (JAX
    ``diagnostics.py:329-425``).

    Everything is computed in float64 on the draws' device, a chunk of
    columns at a time. ESS is the reference estimator applied chain by
    chain and summed over chains; a frozen chain (zero variance) counts 0,
    and with ``n_iters == 1`` each chain counts one draw.

    :param samples: dict ``{name: [n_iters, n_chains, ...]}`` or a single
        such tensor (named ``"x"``).
    :param round_to: decimals in the table.
    :param rank_normalized: rank-normalized + folded R-hat.
    :param n_superchains: when given, the r_hat column is
        :func:`nested_rhat` with this many superchains.
    :return: ``(stats, table)``: ``stats[name]`` holds float64 CPU tensors
        ``mean``, ``sd``, ``r_hat``, ``ess`` of the latent's data shape;
        ``table`` is the JAX package's string.
    """
    if not isinstance(samples, dict):
        samples = {"x": samples}
    stats = {}
    for name, draws in samples.items():
        x = torch.as_tensor(draws)
        if x.ndim < 2:
            raise ValueError(
                "summary expects [n_iters, n_chains, ...] arrays; "
                "{} has shape {}.".format(name, tuple(x.shape)))
        n, m = x.shape[:2]
        data_shape = tuple(x.shape[2:])
        fn = _rhat_fn(n, m, n_superchains)
        flat, chunks = _column_chunks(x)
        parts = {"mean": [], "sd": [], "r_hat": [], "ess": []}
        for cols in chunks:
            xc = flat[:, :, cols].to(torch.float64)
            c = xc.shape[-1]
            parts["mean"].append(xc.mean(dim=(0, 1)))
            parts["sd"].append(xc.reshape(n * m, c).std(dim=0,
                                                         correction=0))
            if rank_normalized:
                bulk, folded = _bulk_and_folded(xc)
                parts["r_hat"].append(torch.maximum(fn(bulk), fn(folded)))
            else:
                parts["r_hat"].append(fn(xc))
            if n < 2:
                parts["ess"].append(torch.full(
                    (c,), float(m), dtype=torch.float64, device=xc.device))
            else:
                per_chain = _ess_from_acov(
                    _batched_reference_acov(xc.reshape(n, m * c)),
                    n).reshape(m, c)
                chain_var = xc.var(dim=0, correction=0)
                per_chain = torch.where(chain_var > 1e-300, per_chain,
                                        torch.zeros_like(per_chain))
                parts["ess"].append(per_chain.sum(dim=0))
        stats[name] = {f: torch.cat(v).reshape(data_shape).cpu()
                       for f, v in parts.items()}
    header = "{:<18}{:>10}{:>10}{:>8}{:>10}".format(
        "latent", "mean", "sd", "r_hat", "ess")
    lines = [header, "-" * len(header)]
    for name, st in stats.items():
        cols = [st[f].reshape(-1).tolist()
                for f in ("mean", "sd", "r_hat", "ess")]
        for i, (mu, sd, rh, es) in enumerate(zip(*cols)):
            label = name if len(cols[0]) == 1 else "{}[{}]".format(name, i)
            lines.append("{:<18}{:>10}{:>10}{:>8}{:>10}".format(
                label, round(mu, round_to), round(sd, round_to),
                round(rh, round_to), int(es)))
    return stats, "\n".join(lines)


def kernel_stein_discrepancy(samples, score_fn, c: float = 1.0,
                             beta: float = -0.5):
    """Kernelized Stein discrepancy (U-statistic) with the IMQ kernel
    ``(c^2 + ||x-y||^2)^beta`` (Gorham & Mackey 2017; JAX
    ``diagnostics.py:428-479``): zero iff the draws match the target whose
    score is ``score_fn``, without its normalizing constant. Built from
    ``[n, n]`` matmuls on the draws' device, with no ``[n, n, d]``
    intermediate.

    :param samples: ``[n, d]`` draws.
    :param score_fn: ``x [n, d] -> grad log p(x) [n, d]`` (vectorized).
    :param c, beta: IMQ kernel parameters.
    :return: 0-d tensor, the KSD^2 estimate (can be slightly negative).
    """
    x = torch.as_tensor(samples)
    if x.ndim != 2:
        raise ValueError(
            "samples must be [n, d]; got shape {}.".format(tuple(x.shape)))
    n, d = x.shape
    if n < 2:
        raise ValueError("KSD needs at least 2 samples.")
    s = score_fn(x)
    x2 = torch.sum(x * x, dim=1)
    r2 = torch.clamp(x2[:, None] + x2[None, :] - 2.0 * (x @ x.T), min=0.0)
    u = c * c + r2
    # One pow for the [n, n] matrix; the other two powers by products.
    p = u ** (beta - 2.0)
    g = 2.0 * beta * p * u  # 2 beta u^(beta-1)
    k = p * u * u  # u^beta
    ss = s @ s.T
    sx = torch.sum(s * x, dim=1)
    s_i_diff = sx[:, None] - s @ x.T
    s_j_diff = (x @ s.T) - sx[None, :]
    trace_term = -(4.0 * beta * (beta - 1.0) * p * r2 + g * d)
    u_p = k * ss - g * s_i_diff + g * s_j_diff + trace_term
    total = torch.sum(u_p) - torch.sum(torch.diagonal(u_p))
    return total / (n * (n - 1))
