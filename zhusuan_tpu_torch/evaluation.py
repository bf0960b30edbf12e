"""Evaluation: marginal likelihood, AIS, and predictive model comparison
(port of ``zhusuan_tpu/evaluation.py``).

Capability parity with reference ``zhusuan/evaluation.py``:
:func:`is_loglikelihood` (evaluation.py:22-54) and the :class:`AIS`
annealed importance sampling driver (evaluation.py:57-172). Beyond the
reference, as in the JAX package: :func:`waic` and :func:`psis_loo`
(Watanabe 2010; Vehtari, Gelman & Gabry 2017) over a pointwise
log-likelihood matrix, which :func:`pointwise_log_likelihood` makes from
posterior draws, and :func:`compare` with the paired standard error.

The JAX package anneals in one ``lax.scan`` and traces the tempered
log-joint into its HMC kernel on a TPU. Here the annealing is a Python loop
over ``HMC.sample``. The tempered log-joint is a closure, which a CUDA
kernel cannot take, unless :class:`AIS` gets the pair of built-in densities
``prior_density=`` / ``target_density=``: each transition then targets their
:class:`~zhusuan_tpu_torch.ops.densities.TemperedLogJoint` at a device-scalar
temperature, which the HMC kernel evaluates on the card. The criteria compute
in float64 on the input's device (the JAX package's host-side numpy), a few
data points' tail fits at a time.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet
from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.mcmc.hmc import HMC
from zhusuan_tpu_torch.ops.densities import (
    BuiltinDensity,
    TemperedLogJoint,
    check_builtin_gaps,
    check_tempered_pair,
)
from zhusuan_tpu_torch.utils import log_mean_exp, merge_dicts
from zhusuan_tpu_torch.variational.monte_carlo import (
    ImportanceWeightedObjective,
)

__all__ = [
    "is_loglikelihood",
    "AIS",
    "pointwise_log_likelihood",
    "waic",
    "psis_loo",
    "psis_smooth_log_weights",
    "WAICResult",
    "LOOResult",
    "compare",
    "ComparisonRow",
]


def is_loglikelihood(meta_bn, observed, latent=None, axis=None,
                     proposal=None):
    """Marginal log-likelihood estimate by self-normalized importance
    sampling: the importance-weighted objective evaluated as a value
    (reference ``evaluation.py:22-54``).

    :param meta_bn: MetaBayesianNet or log-joint callable.
    :param observed: dict of observations.
    :param latent: ``{name: (samples, log_probs)}`` (exclusive with
        ``proposal``).
    :param axis: the sample axis to reduce (log-mean-exp).
    :param proposal: a BayesianNet proposal whose unobserved stochastic
        nodes provide samples and log-probs.
    :return: the estimated log-likelihood tensor.
    """
    return ImportanceWeightedObjective(
        meta_bn, observed, latent=latent, axis=axis,
        variational=proposal).tensor


class AIS:
    """Annealed importance sampling (Neal 2001) for marginal log-likelihood
    lower bounds, with HMC transitions along a sigmoid temperature
    schedule (reference ``evaluation.py:57-172``; JAX
    ``evaluation.py:70-236``).

    The tempered density is ``log f_T = (1-T) log_prior + T log_joint``;
    the schedule ``sigmoid(4 (2t/T - 1))`` normalized to [0, 1], in
    float64 on the host, then cast to the chains' dtype. The chains start
    from the proposal; ``n_adapt`` iterations adapt the step size at the
    schedule's third temperature; the chains then restart from a fresh
    proposal draw (the adapted step size and counter kept) and anneal with
    every adaptation channel frozen (step size, mass, the t-based
    step-size search), so each transition leaves its ``f_T`` invariant.
    The weights telescope ``log f_T(x_{t-1}) - log f_T(x_t)`` from the
    sampler's own log-probs and end with ``+ log f_1(x_T)``.

    With ``prior_density`` and ``target_density`` (the JAX package's closure
    traced into its kernel, in the port's terms), every transition, warm-up
    included, targets ``TemperedLogJoint(prior_density, target_density,
    T)`` with ``T`` a device scalar, so HMC takes its CUDA kernel on the
    card. A built-in may drop its density's normalising constant: each
    increment is taken at one temperature, where the constant cancels, and
    the two end terms come from the models, ``-log_prior(x_0)`` from the
    proposal and ``+log_joint(x_T)`` from ``meta_bn`` under ``observed``, so
    the estimate keeps the models' constants. :meth:`run` checks once, on
    the initial chains, that each built-in differs from its model's
    log-density by a constant.

    :param meta_bn: model (MetaBayesianNet or log-joint callable).
    :param proposal_meta_bn: proposal MetaBayesianNet; the chains start
        from its draws and ``log_prior`` is its log-joint.
    :param hmc: an :class:`~zhusuan_tpu_torch.mcmc.HMC`, the transition.
    :param observed: dict of observations.
    :param latent: list of latent node names (or a dict whose keys are).
    :param n_temperatures: annealing steps.
    :param n_adapt: step-size adaptation iterations before annealing.
    :param prior_density: optional built-in density equal to the
        proposal's log-density up to a constant, over the one latent (a
        pair :class:`~zhusuan_tpu_torch.ops.densities.TemperedLogJoint`
        takes, with ``target_density``).
    :param target_density: optional built-in density equal to ``meta_bn``'s
        log-joint under ``observed`` up to a constant, over the same latent.
    """

    def __init__(self, meta_bn, proposal_meta_bn: MetaBayesianNet, hmc: HMC,
                 observed: Dict, latent: Union[List[str], Dict],
                 n_temperatures: int = 1000, n_adapt: int = 30, *,
                 prior_density: Optional[BuiltinDensity] = None,
                 target_density: Optional[BuiltinDensity] = None):
        self._log_joint = make_log_joint_fn(meta_bn, {})
        self._proposal = proposal_meta_bn
        self._log_prior = make_log_joint_fn(proposal_meta_bn, {})
        self._hmc = hmc
        self._observed = dict(observed)
        self._latent_names = (list(latent.keys()) if isinstance(latent, dict)
                              else list(latent))
        if int(n_temperatures) < 1:
            raise ValueError("n_temperatures must be >= 1.")
        self._n_temperatures = int(n_temperatures)
        self._n_adapt = int(n_adapt)
        if (prior_density is None) != (target_density is None):
            raise ValueError(
                "prior_density and target_density go together.")
        self._builtin_pair = None
        if prior_density is not None:
            self._builtin_pair = check_tempered_pair(
                prior_density, target_density, self._latent_names)

    def _map_t(self, t):
        return 1.0 / (1.0 + np.exp(-4 * (2 * t / self._n_temperatures - 1)))

    def _schedule(self):
        """The ``n_temperatures + 1`` temperatures, float64 numpy, exactly
        0 and 1 at the ends (reference evaluation.py:112-117)."""
        t = np.arange(self._n_temperatures + 1, dtype=np.float64)
        mapped = self._map_t(t)
        return (mapped - mapped[0]) / (mapped[-1] - mapped[0])

    def _tempered_log_fn(self, temperature):
        if self._builtin_pair is not None:
            return TemperedLogJoint(*self._builtin_pair, temperature)

        def log_fn(obs):
            return (self._log_prior(obs) * (1.0 - temperature)
                    + self._log_joint(obs) * temperature)

        return log_fn

    def _init_latent(self, seed):
        bn = self._proposal.observe(key=seed)
        return {name: bn[name].tensor.detach()
                for name in self._latent_names}

    @torch.no_grad()
    def run(self, key=None):
        """Run the whole evaluation: a Python loop of ``n_adapt +
        n_temperatures`` HMC iterations on the proposal's device.

        :param key: a CPU ``torch.Generator`` (None: a fresh one seeded 0)
            from which the proposal's two seeds and the sampler's two keys
            are drawn (the JAX package's ``split(key, 4)``).
        :return: 0-d tensor, the mean over the data of the per-chain
            log-mean-exp lower bound.
        """
        if key is None:
            key = torch.Generator().manual_seed(0)
        s_init, s_reinit, a0, a1, r0, r1 = draw_keys(key, 6)
        key_adapt, key_run = (a0, a1), (r0, r1)
        # The phase-1 draw gives the chain dtype (no separate shape probe).
        q0 = self._init_latent(s_init)
        first = next(iter(q0.values()))
        dtype = first.dtype
        for v in q0.values():
            dtype = torch.promote_types(dtype, v.dtype)
        schedule = torch.as_tensor(self._schedule(), dtype=dtype,
                                   device=first.device)

        # The built-ins hold their data: the sampler gets no observations.
        builtin = self._builtin_pair is not None
        observed = {} if builtin else self._observed
        if builtin:
            prior, target = self._builtin_pair
            check_builtin_gaps(
                [("prior_density", prior(q0), self._log_prior(q0)),
                 ("target_density", target(q0),
                  self._log_joint(merge_dicts(q0, self._observed)))],
                "initial chains")

        # --- phase 1: step-size adaptation at a small temperature ------- #
        adp_t = schedule[2 if self._n_temperatures > 1 else 1]
        adapt_fn = self._tempered_log_fn(adp_t)
        state = self._hmc.init(q0, log_joint=adapt_fn, observed=observed)
        adapt_enabled = self._hmc.adapt_step_size is not None
        for _ in range(self._n_adapt):
            state, _ = self._hmc.sample(
                adapt_fn, observed, state, key_adapt,
                adapt_step_size=True if adapt_enabled else None)

        # --- phase 2: re-init the chains from the proposal -------------- #
        # The adapted step-size state and the counter stay (resetting t
        # would re-trigger the t-based step-size search).
        q = self._init_latent(s_reinit)
        state = state._replace(q=q)
        if builtin:
            log_weights = -self._log_prior(q)
        else:
            log_weights = -self._tempered_log_fn(schedule[0])(
                merge_dicts(q, self._observed))

        # --- phase 3: annealing, every adaptation channel frozen -------- #
        log_prob = None
        for i in range(1, self._n_temperatures + 1):
            state, info = self._hmc.sample(
                self._tempered_log_fn(schedule[i]), observed, state,
                key_run,
                adapt_step_size=False if adapt_enabled else None,
                adapt_mass=(False if self._hmc.adapt_mass is not None
                            else None),
                init_step_size_search=False)
            log_weights = log_weights + info.orig_log_prob - info.log_prob
            log_prob = info.log_prob
        # Final correction: add back log f_1 at the last position (the
        # model's, whose constant a built-in may lack).
        if builtin:
            log_prob = self._log_joint(merge_dicts(state.q, self._observed))
        log_weights = log_weights + log_prob
        bound = log_mean_exp(log_weights, axis=0)
        return torch.mean(bound)


# --------------------------------------------------------------------- #
# Predictive model comparison: WAIC and PSIS-LOO (beyond the reference)  #
# --------------------------------------------------------------------- #
class WAICResult(NamedTuple):
    """:func:`waic` output: float64 tensors on the input's device
    (``pointwise`` has the data shape of the input's trailing axes)."""

    elpd_waic: torch.Tensor  # scalar sum of pointwise elpd
    p_waic: torch.Tensor  # scalar effective number of parameters
    se: torch.Tensor  # scalar standard error of elpd_waic
    pointwise: torch.Tensor  # per-datapoint elpd contributions


class LOOResult(NamedTuple):
    """:func:`psis_loo` output. ``pareto_k > 0.7`` flags data points whose
    importance weights are unreliable (Vehtari et al. 2017 §2.2)."""

    elpd_loo: torch.Tensor
    p_loo: torch.Tensor
    se: torch.Tensor
    pareto_k: torch.Tensor  # per-datapoint GPD shape diagnostic
    pointwise: torch.Tensor


def pointwise_log_likelihood(meta_bn, draws, observed, node, key=None):
    """Pointwise log-likelihood matrix from posterior draws: the model
    re-executed once per draw with the draw and the observations pinned,
    reading the likelihood node's conditional log-probability (JAX
    ``evaluation.py:263-296``).

    With ``key=None`` every node must be pinned (by ``draws`` or
    ``observed``): the draws are batched through ``torch.func.vmap``, one
    pass of batched ops over all of them (a node that would draw raises).
    With a ``key`` (a CPU ``torch.Generator``) each draw gets its own net
    seed and the model runs once per draw in a Python loop.

    :param meta_bn: the model :class:`MetaBayesianNet`.
    :param draws: ``{name: [n_draws, ...]}`` posterior draws.
    :param observed: the observation dict (shared by every draw).
    :param node: the likelihood node, declared with ``group_ndims=0`` so
        its entries stay per data point.
    :return: ``[n_draws] + data_shape`` tensor.
    """
    draws = {k: torch.as_tensor(v) for k, v in draws.items()}
    n_set = {v.shape[0] for v in draws.values()}
    if len(n_set) != 1:
        raise ValueError(
            "All draw arrays must share a leading n_draws axis; got "
            "shapes {}.".format({k: tuple(v.shape)
                                 for k, v in draws.items()}))
    n_draws = n_set.pop()

    def one(d, seed=None):
        bn = meta_bn.observe(key=seed, **merge_dicts(d, observed))
        return bn.cond_log_prob(node)

    if key is None:
        return torch.func.vmap(one)(draws)
    seeds = draw_keys(key, n_draws)
    return torch.stack([one({k: v[i] for k, v in draws.items()}, seeds[i])
                        for i in range(n_draws)])


def _prepare_ll(log_likelihood):
    """``[S, ...data]`` -> float64 ``[S, n]`` matrix and the data shape."""
    ll = torch.as_tensor(log_likelihood).to(torch.float64)
    if ll.ndim < 2:
        raise ValueError(
            "log_likelihood must be [n_draws, n_data...]-shaped, got "
            "shape {}.".format(tuple(ll.shape)))
    data_shape = tuple(ll.shape[1:])
    return ll.reshape(ll.shape[0], -1), data_shape


def _logsumexp0(x):
    m = torch.amax(x, dim=0)
    return m + torch.log(torch.sum(torch.exp(x - m[None]), dim=0))


def _se(elpd_i):
    n = elpd_i.shape[0]
    if n > 1:
        return torch.sqrt(n * elpd_i.var(correction=1))
    return torch.zeros((), dtype=elpd_i.dtype, device=elpd_i.device)


def waic(log_likelihood) -> WAICResult:
    """Widely applicable information criterion (Watanabe 2010), elpd
    convention of Vehtari, Gelman & Gabry (2017) Eq. 4-5:
    ``elpd_i = log mean_s p(y_i | theta_s) - Var_s[log p(y_i | theta_s)]``.

    :param log_likelihood: ``[n_draws, n_data...]`` pointwise
        log-likelihoods (see :func:`pointwise_log_likelihood`).
    """
    ll, data_shape = _prepare_ll(log_likelihood)
    s = ll.shape[0]
    lppd_i = _logsumexp0(ll) - math.log(s)
    p_i = ll.var(dim=0, correction=1)
    elpd_i = lppd_i - p_i
    return WAICResult(elpd_waic=torch.sum(elpd_i), p_waic=torch.sum(p_i),
                      se=_se(elpd_i), pointwise=elpd_i.reshape(data_shape))


def _gpd_fit(exc):
    """Generalized-Pareto fit to exceedances (Zhang & Stephens 2009
    empirical-Bayes estimator, the PSIS paper's recommendation; JAX
    ``evaluation.py:343-381``).

    :param exc: ``[M, C]`` ascending positive exceedances, a column a data
        point.
    :return: ``(xi, sigma)``, each ``[C]``, in the standard convention
        (scipy ``genpareto(c=xi, scale=sigma)``), with the weakly
        informative prior toward xi = 0.5 applied.
    """
    m_tail = exc.shape[0]
    n_b = 30 + int(math.sqrt(m_tail))
    j = torch.arange(1, n_b + 1, dtype=exc.dtype, device=exc.device)
    x_quart = exc[int(m_tail / 4 + 0.5) - 1]
    # Candidate b = k / sigma; every b < 1 / x_max keeps 1 - b x > 0.
    b = (1.0 / exc[-1][None]
         + (1.0 - torch.sqrt(n_b / (j - 0.5)))[:, None]
         / (3.0 * x_quart)[None])
    # Profile likelihood (Z&S Eq. 7) and the grid's softmax weights.
    log1mbx = torch.log1p(-b[:, None, :] * exc[None, :, :])
    k_b = -torch.mean(log1mbx, dim=1)
    profile = m_tail * (torch.log(b / k_b) + k_b - 1.0)
    profile = profile - torch.amax(profile, dim=0)[None]
    w_raw = torch.exp(profile)
    w = w_raw / torch.sum(w_raw, dim=0)[None]
    b_hat = torch.sum(w * b, dim=0)
    k_hat = -torch.mean(torch.log1p(-b_hat[None] * exc), dim=0)
    xi = -k_hat
    sigma = k_hat / b_hat
    xi = (m_tail * xi + 5.0) / (m_tail + 10.0)
    return xi, sigma


def _gpd_quantile(p, xi, sigma):
    """Standard-convention GPD quantile, elementwise over columns."""
    small = torch.abs(xi) < 1e-12
    xi_safe = torch.where(small, torch.full_like(xi, 1e-12), xi)
    q = (sigma[None] * torch.expm1(-xi_safe[None] * torch.log1p(-p[:, None]))
         / xi_safe[None])
    q_lim = -sigma[None] * torch.log1p(-p[:, None])
    return torch.where(small[None], q_lim, q)


def psis_smooth_log_weights(log_ratios, _chunk: int = 1 << 22):
    """Pareto-smoothed importance sampling weights (Vehtari, Simpson,
    Gelman, Yao & Gabry 2024; JAX ``evaluation.py:394-448``): a GPD fitted
    to the largest ``M = min(0.2 S, 3 sqrt(S))`` raw ratios of every
    column (stable sort), those replaced by the fitted quantiles at
    ``(z - 0.5) / M``, capped at the raw maximum. The fit's
    ``[n_b, M, C]`` workspace goes ``_chunk`` values at a time.

    :param log_ratios: ``[S, C]`` raw log importance ratios.
    :return: ``(log_weights [S, C], khat [C])``, float64 on the input's
        device; the weights UNNORMALIZED (max-shifted). With ``S`` too
        small for a tail fit (``M < 5``) every column passes through
        unsmoothed with ``khat = inf``; a zero-variation tail with
        ``khat = -inf``.
    """
    lr = torch.as_tensor(log_ratios).to(torch.float64)
    s, c = lr.shape
    lr = lr - torch.amax(lr, dim=0)[None]
    m_tail = int(min(0.2 * s, 3.0 * math.sqrt(s)))
    if m_tail < 5:
        return lr, torch.full((c,), math.inf, dtype=lr.dtype,
                              device=lr.device)
    srt, order = torch.sort(lr, dim=0, stable=True)
    cutoff = srt[s - m_tail - 1]
    tail = srt[s - m_tail:]
    exc = torch.exp(tail) - torch.exp(cutoff)[None]
    ok = (exc[-1] > 0) & torch.all(torch.isfinite(exc), dim=0)
    khat = torch.full((c,), -math.inf, dtype=lr.dtype, device=lr.device)
    smoothed = tail.clone()
    idx_ok = torch.nonzero(ok).reshape(-1)
    n_b = 30 + int(math.sqrt(m_tail))
    cols_per = max(1, _chunk // max(1, n_b * m_tail))
    p = (torch.arange(m_tail, dtype=lr.dtype, device=lr.device) + 0.5) \
        / m_tail
    for start in range(0, idx_ok.numel(), cols_per):
        cols = idx_ok[start:start + cols_per]
        e = torch.clamp(exc[:, cols], min=1e-300)
        xi, sigma = _gpd_fit(e)
        good = torch.isfinite(xi) & torch.isfinite(sigma) & (sigma > 0)
        q = _gpd_quantile(p, xi, sigma)
        sm = torch.log(torch.exp(cutoff[cols])[None] + q)
        sm = torch.clamp(sm, max=0.0)  # the raw maximum, 0 after the shift
        smoothed[:, cols] = torch.where(good[None], sm, tail[:, cols])
        khat[cols] = torch.where(good, xi, torch.full_like(xi, math.inf))
    out = torch.cat([srt[:s - m_tail], smoothed], dim=0)
    return torch.empty_like(out).scatter_(0, order, out), khat


def psis_loo(log_likelihood) -> LOOResult:
    """PSIS-LOO: the leave-one-out expected log predictive density by
    Pareto-smoothed importance sampling (Vehtari, Gelman & Gabry 2017):
    ratios ``1 / p(y_i | theta_s)`` of full-posterior draws, their right
    tail smoothed, then ``elpd_i = log sum_s w_s p(y_i|theta_s) /
    sum_s w_s``.

    :param log_likelihood: ``[n_draws, n_data...]`` pointwise
        log-likelihoods from draws of the full posterior.
    """
    ll, data_shape = _prepare_ll(log_likelihood)
    s = ll.shape[0]
    lw, khat = psis_smooth_log_weights(-ll)
    lw = lw - _logsumexp0(lw)[None]
    elpd_i = _logsumexp0(lw + ll)
    lppd_i = _logsumexp0(ll) - math.log(s)
    return LOOResult(elpd_loo=torch.sum(elpd_i),
                     p_loo=torch.sum(lppd_i - elpd_i), se=_se(elpd_i),
                     pareto_k=khat.reshape(data_shape),
                     pointwise=elpd_i.reshape(data_shape))


class ComparisonRow(NamedTuple):
    """One row of :func:`compare` (models ranked best first)."""

    name: str
    rank: int
    elpd: float  # elpd_loo or elpd_waic of this model
    se: float  # standard error of this model's elpd
    elpd_diff: float  # elpd(best) - elpd(this); 0 for the best row
    dse: float  # PAIRED standard error of that difference
    p_eff: float  # effective parameter count (p_loo / p_waic)
    warning: bool  # any pareto_k > 0.7 (LOO results only)


def compare(results) -> "list[ComparisonRow]":
    """Rank models by expected log predictive density, with the PAIRED
    standard error of each difference over the shared data points
    (Vehtari, Gelman & Gabry 2017 Eq. 24; JAX ``evaluation.py:486-532``).

    :param results: ``{model_name: LOOResult | WAICResult}``, all scored
        on the same data.
    :return: list of :class:`ComparisonRow`, best model first.
    """
    if len(results) < 2:
        raise ValueError("compare needs at least two models.")
    point = {name: torch.as_tensor(res.pointwise).to(
        device="cpu", dtype=torch.float64).reshape(-1)
        for name, res in results.items()}
    shapes = {tuple(v.shape) for v in point.values()}
    if len(shapes) != 1:
        raise ValueError(
            "All models must be scored on the same data; pointwise "
            "shapes differ: {}.".format(
                {k: tuple(v.shape) for k, v in point.items()}))
    order = sorted(results, key=lambda k: -float(torch.sum(point[k])))
    best = order[0]
    n = point[best].shape[0]
    rows = []
    for rank, name in enumerate(order):
        res = results[name]
        diff_i = point[best] - point[name]
        dse = (float(torch.sqrt(n * diff_i.var(correction=1)))
               if (name != best and n > 1) else 0.0)
        k = getattr(res, "pareto_k", None)
        p_eff = res.p_loo if isinstance(res, LOOResult) else res.p_waic
        rows.append(ComparisonRow(
            name=name,
            rank=rank,
            elpd=float(torch.sum(point[name])),
            se=float(res.se),
            elpd_diff=float(torch.sum(diff_i)),
            dse=dse,
            p_eff=float(p_eff),
            warning=(bool(torch.any(torch.as_tensor(k) > 0.7))
                     if k is not None else False),
        ))
    return rows
