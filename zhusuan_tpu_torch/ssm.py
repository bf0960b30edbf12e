"""State-space models: particle filtering, smoothing, particle Gibbs and
PMMH, exact discrete HMMs and exact Kalman filtering (port of
``zhusuan_tpu/ssm.py``).

A bootstrap / guided particle filter over time series (an unbiased
evidence estimate and the filtering clouds), forward-filter
backward-sampling (FFBS), conditional SMC with ancestor sampling (the
particle-Gibbs kernel), pseudo-marginal Metropolis-Hastings over model
parameters, and the closed-form baselines: the forward-backward / Viterbi /
Baum-Welch family for discrete HMMs and the Kalman filter / RTS smoother
for linear-Gaussian models.

The JAX package runs every filter as one ``lax.scan``. Here the loops over
time are Python loops whose steps stay on the device:

- particles are the leading axis of every array; one filter step is
  systematic resampling (cumsum + ``torch.searchsorted`` gather) chosen by
  a device select on ``ess < threshold * n`` (the resampled cloud is always
  computed, as JAX draws its key either way), then the proposal, then the
  reweight (logsumexp). No step reads the device back, so the filter also
  runs under ``torch.func.vmap``, which is how :class:`PseudoMarginalMH`
  runs its chains as one batch;
- the ``t > 0`` branch of a step is a host branch on the loop counter;
- categorical draws are Gumbel-max (``jax.random.categorical``'s), the
  Gumbels injectable through ``noise=``;
- ``parallel=True`` replaces the sequential HMM and Kalman recursions by
  :func:`_associative_scan`, a log-depth odd/even scan over a pytree of
  tensors (``jax.lax.associative_scan``'s recursion; torch has none);
  gradients flow through it. ``parallel=None``, the default, takes the
  scan on a CUDA device and the sequential loop on the CPU
  (:func:`_use_scan`).

User callables take a ``torch.Generator`` where JAX's take a key:
``init_fn(gen, n)``, ``transition_fn(gen, x, t)`` and ``proposal_fn(gen,
x, y, t)``; ``t`` is a host int. ``key`` arguments are a
``torch.Generator`` or a Philox key pair; step ``t`` of a filter draws from
``iteration_generator(key, t + 1)`` on the observations' device (the
resampling uniform first, then the proposal), ``init_fn`` from
``iteration_generator(key, 0)``. With ``noise=`` the callables get
``None`` in place of the generator.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import dual_averaging_update, tree_normal_like
from zhusuan_tpu_torch.mcmc.rwm import _pick
from zhusuan_tpu_torch.ops._random import (
    as_key,
    child_key,
    iteration_generator,
)
from zhusuan_tpu_torch.smc import systematic_indices
from zhusuan_tpu_torch.utils import tree_leaves, tree_map

__all__ = [
    "ParticleFilter",
    "PFResult",
    "CSMCResult",
    "ParticleGibbs",
    "PseudoMarginalMH",
    "PMMHState",
    "PMMHInfo",
    "kalman_filter",
    "kalman_smoother",
    "KalmanResult",
    "hmm_filter",
    "hmm_smoother",
    "hmm_posterior_sample",
    "hmm_viterbi",
    "hmm_expected_stats",
    "hmm_mstep",
    "HMMStats",
]


def _tree_stack(trees, dim=0):
    """Stack a list of trees of one structure leafwise."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *trees)


def _weighted_mean(w, a):
    """``sum_i w[i] a[i]`` over the particle axis (one matmul)."""
    a = a.to(w.dtype)
    if a.ndim <= 2:
        return w @ a
    return (w @ a.reshape(a.shape[0], -1)).reshape(a.shape[1:])


def _gumbel(generator, shape, dtype, device):
    """Standard Gumbels ``-log(-log(u))``, ``u`` uniform on (tiny, 1) as
    ``jax.random.gumbel`` draws them."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def _gumbels(noise, name, generator, shape, dtype, device, index=None):
    """The Gumbels of a categorical draw: ``noise[name]`` (indexed along
    ``index``'s axis) when ``noise`` is given, else fresh draws."""
    if noise is None:
        return _gumbel(generator, shape, dtype, device)
    g = torch.as_tensor(noise[name], dtype=dtype, device=device)
    if index is not None:
        axis, i = index
        g = g.select(axis, i)
    return g


class CSMCResult(NamedTuple):
    """Output of :meth:`ParticleFilter.conditional_run`."""

    trajectory: Any  # pytree of [T, ...]: the selected path
    log_z: torch.Tensor  # scalar evidence estimate from this sweep
    ancestor_moves: torch.Tensor  # scalar: steps where ancestor sampling
    #                               moved the reference off its own past


class PFResult(NamedTuple):
    """Output of :meth:`ParticleFilter.run`."""

    particles: Any  # final-time particle cloud pytree, [n_particles, ...]
    log_w: torch.Tensor  # [n_particles] final normalized log-weights
    log_z: torch.Tensor  # scalar log p(y_{0:T-1}) estimate
    filter_means: Any  # pytree of [T, ...] self-normalized filtering means
    ess: torch.Tensor  # [T] effective sample size after each reweight
    n_resamples: torch.Tensor  # scalar resampling-event count
    history: Any  # store_history=True: pytree of [T, n_particles, ...]
    #               post-propagation clouds, else None
    log_w_history: Optional[torch.Tensor]  # [T, n_particles] matching
    #               normalized log-weights, else None


class ParticleFilter:
    """Sequential Monte Carlo for state-space models.

    The model is functional (callables over vectorized particle clouds):

    - ``init_fn(gen, n_particles) -> particles``: the t = 0 cloud from
      p(x_0); any pytree (dict / list / tuple of tensors, or a tensor) whose
      leaves carry the particle axis first. ``gen`` is a
      ``torch.Generator`` (None under ``noise=``).
    - ``transition_fn(gen, particles, t) -> particles``: propagate the whole
      cloud x_{t-1} -> x_t ~ p(x_t | x_{t-1}).
    - ``emission_log_prob(particles, y, t) -> [n_particles]``: log p(y_t |
      x_t) per particle.

    With only these three the filter is the BOOTSTRAP filter. A guided
    filter adds ``proposal_fn(gen, particles, y, t) -> particles``, which
    sees the incoming observation, with ``proposal_log_prob(new, old, y, t)``
    and ``transition_log_prob(new, old, t)``, so the incremental weight is
    emission + transition - proposal. ``transition_log_prob`` alone also
    enables :meth:`smooth` and ancestor sampling.

    Resampling is conditional systematic (shared with
    :class:`~zhusuan_tpu_torch.smc.AnnealedSMC`): when ESS <
    ``resample_threshold * n_particles``; 1.0 resamples always, 0.0 never.

    :param init_fn: initial-cloud sampler.
    :param transition_fn: transition sampler.
    :param emission_log_prob: observation log-density.
    :param n_particles: cloud size.
    :param proposal_fn: optional guided proposal sampler.
    :param proposal_log_prob: proposal log-density (with ``proposal_fn``).
    :param transition_log_prob: transition log-density (with
        ``proposal_fn``; alone it enables :meth:`smooth`).
    :param resample_threshold: ESS fraction triggering resampling.
    """

    def __init__(
        self,
        init_fn: Callable,
        transition_fn: Callable,
        emission_log_prob: Callable,
        n_particles: int,
        proposal_fn: Optional[Callable] = None,
        proposal_log_prob: Optional[Callable] = None,
        transition_log_prob: Optional[Callable] = None,
        resample_threshold: float = 0.5,
    ):
        if int(n_particles) < 2:
            raise ValueError("n_particles must be >= 2.")
        if (proposal_fn is None) != (proposal_log_prob is None):
            raise ValueError(
                "proposal_fn and proposal_log_prob must be supplied "
                "together (a guided proposal needs its density for the "
                "weight correction).")
        if proposal_fn is not None and transition_log_prob is None:
            raise ValueError(
                "a guided proposal additionally needs transition_log_prob "
                "for the importance-weight correction.")
        if not 0.0 <= float(resample_threshold) <= 1.0:
            raise ValueError("resample_threshold must be in [0, 1].")
        self._init_fn = init_fn
        self._transition_fn = transition_fn
        self._emission_log_prob = emission_log_prob
        self._proposal_fn = proposal_fn
        self._proposal_log_prob = proposal_log_prob
        self._transition_log_prob = transition_log_prob
        self._n = int(n_particles)
        self._resample_threshold = float(resample_threshold)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _series(ys):
        leaves = tree_leaves(ys)
        if not leaves:
            raise ValueError("ys must contain at least one observation "
                             "array.")
        return leaves[0].shape[0], leaves[0].device

    def _probe(self, x0, ys):
        """The emission's dtype and its shape contract, from one evaluation
        at t = 0 (JAX's shape-only probe has no torch counterpart)."""
        y0 = tree_map(lambda a: a[0], ys)
        lw = self._emission_log_prob(x0, y0, 0)
        if tuple(lw.shape) != (self._n,):
            raise ValueError(
                "emission_log_prob must return [n_particles]={} log-"
                "densities, got shape {}.".format((self._n,),
                                                  tuple(lw.shape)))
        return lw.dtype

    def _propagate(self, gen, x_prev, y, t, dtype):
        """Propose x_t; returns (x_t, the log-weight correction or None)."""
        if self._proposal_fn is None:
            return self._transition_fn(gen, x_prev, t), None
        x = self._proposal_fn(gen, x_prev, y, t)
        corr = (self._transition_log_prob(x, x_prev, t)
                - self._proposal_log_prob(x, x_prev, y, t))
        return x, corr.to(dtype)

    # -- the filter --------------------------------------------------------

    def run(self, key, ys, store_history: bool = False, *,
            noise=None) -> PFResult:
        """Run the filter over ``ys`` (pytree, leading axis = time): a
        Python loop over T with no host read.

        :param key: a ``torch.Generator`` or a Philox key pair.
        :param ys: observations; every leaf ``[T, ...]`` on the filter's
            device.
        :param store_history: keep the per-step clouds and weights
            (``[T, n_particles, ...]``; needed by :meth:`smooth`).
        :param noise: testing hook: the ``[T]`` resampling uniforms (the
            callables then draw their own numbers from ``None``).
        """
        T, device = self._series(ys)
        n = self._n
        if noise is None:
            key = as_key(key)
        gen = None if noise is not None else iteration_generator(key, 0,
                                                                 device)
        x = self._init_fn(gen, n)
        dtype = self._probe(x, ys)
        log_n = math.log(n)
        uniform = torch.full((n,), -log_n, dtype=dtype, device=device)
        grid = torch.arange(n, dtype=dtype, device=device)
        # The weights are carried normalized: JAX's next-step
        # ``log_w - logsumexp(log_w)`` is this step's ``lw_out``, as its
        # ``logsumexp(log_w)`` is the evidence increment's; so one
        # logsumexp a step, and the ESS is ``1 / sum(w^2)``.
        lw_n = uniform
        log_z = torch.zeros((), dtype=dtype, device=device)
        ess_t, means_t, hist, lw_hist, resampled = [], [], [], [], []
        for t in range(T):
            y = tree_map(lambda a: a[t], ys)
            if noise is None:
                gen, u = iteration_generator(key, t + 1, device), None
            else:
                u = noise[t]
            # 1. Conditional resampling on the INCOMING weights.
            w = torch.exp(lw_n)
            ess_in = torch.reciprocal(torch.dot(w, w))
            idx = systematic_indices(w, gen, u, grid)
            do = ess_in < self._resample_threshold * n
            x = tree_map(lambda a: _pick(do, a[idx], a), x)
            lw_n = torch.where(do, uniform, lw_n)
            resampled.append(do)
            # 2. Propagate (t = 0: init_fn drew the time-0 cloud).
            corr = None
            if t > 0:
                x, corr = self._propagate(gen, x, y, t, dtype)
            # 3. Reweight; the evidence takes the previous NORMALIZED
            # weights.
            lw_inc = self._emission_log_prob(x, y, t)
            if corr is not None:
                lw_inc = lw_inc + corr
            log_w = lw_n + lw_inc
            inc = torch.logsumexp(log_w, 0)
            log_z = log_z + inc
            lw_n = log_w - inc
            w = torch.exp(lw_n)
            ess_t.append(torch.reciprocal(torch.dot(w, w)))
            means_t.append(tree_map(lambda a: _weighted_mean(w, a), x))
            if store_history:
                hist.append(x)
                lw_hist.append(lw_n)
        n_resamples = torch.sum(torch.stack(resampled), dtype=torch.int32)
        return PFResult(
            particles=x,
            log_w=lw_n,
            log_z=log_z,
            filter_means=_tree_stack(means_t),
            ess=torch.stack(ess_t),
            n_resamples=n_resamples,
            history=_tree_stack(hist) if store_history else None,
            log_w_history=torch.stack(lw_hist) if store_history else None,
        )

    def smooth(self, key, result: PFResult, n_paths: int, *, noise=None):
        """Forward-filter backward-sampling (Godsill, Doucet & West 2004):
        ``n_paths`` joint smoothing trajectories from the stored history.

        Every path picks its final state from the final weights, then for
        t = T-2..0 reweights the time-t cloud by the transition density into
        its chosen x_{t+1} and draws. The paths are a batch axis (the user's
        ``transition_log_prob`` runs under ``torch.func.vmap`` over them):
        O(T * n_paths * n_particles) density evaluations, a Python loop over
        T.

        :param key: a ``torch.Generator`` or a Philox key pair.
        :param result: a :meth:`run` output with ``store_history=True``.
        :param n_paths: number of trajectories.
        :param noise: testing hook: ``{"last": [n_paths, n], "back":
            [n_paths, T-1, n]}`` Gumbels, ``back`` in reversed time order.
        :return: pytree of ``[n_paths, T, ...]`` trajectories.
        """
        if self._transition_log_prob is None:
            raise ValueError(
                "smooth() needs transition_log_prob (FFBS reweights by "
                "transition densities).")
        if result.history is None:
            raise ValueError(
                "smooth() needs the filter history: re-run with "
                "store_history=True.")
        xs, lws = result.history, result.log_w_history
        T, n = lws.shape
        P = int(n_paths)
        dtype, device = lws.dtype, lws.device
        if noise is None:
            key = as_key(key)

        def gen_for(s):
            return (None if noise is not None
                    else iteration_generator(key, s, device))

        g = _gumbels(noise, "last", gen_for(0), (P, n), dtype, device)
        idx = torch.argmax(lws[T - 1] + g, -1)
        x_next = tree_map(lambda a: a[T - 1][idx], xs)
        traj = [x_next]
        for s, t in enumerate(range(T - 2, -1, -1)):
            x_t_all = tree_map(lambda a: a[t], xs)
            tlp = torch.func.vmap(
                lambda xn: self._transition_log_prob(xn, x_t_all, t + 1))(
                    x_next)
            g = _gumbels(noise, "back", gen_for(s + 1), (P, n), dtype,
                         device, index=(1, s))
            idx = torch.argmax(lws[t] + tlp + g, -1)
            x_next = tree_map(lambda a: a[idx], x_t_all)
            traj.append(x_next)
        return _tree_stack(traj[::-1], dim=1)

    # -- conditional SMC (the particle-Gibbs kernel) -----------------------

    def conditional_run(self, key, ys, ref, ancestor_sampling: bool = True,
                        *, noise=None) -> CSMCResult:
        """Conditional SMC sweep (Andrieu, Doucet & Holenstein 2010) with
        optional ancestor sampling (Lindsten, Jordan & Schon 2014): the
        reference trajectory ``ref`` is forced into particle slot 0, and one
        trajectory is drawn from the final weights by ancestral trace-back.
        Iterating ``ref -> conditional_run -> trajectory`` leaves
        ``p(x_{0:T-1} | y_{0:T-1})`` invariant.

        Resampling is multinomial (Gumbel-max) at EVERY step. Ancestor
        sampling redraws the reference's ancestor from ``w_{t-1} p(ref_t |
        x_{t-1})`` each step (it needs ``transition_log_prob``); without it
        the reference keeps its own past.

        :param key: a ``torch.Generator`` or a Philox key pair.
        :param ys: observations, leaves ``[T, ...]``.
        :param ref: reference trajectory pytree, leaves ``[T, ...]``.
        :param ancestor_sampling: use ancestor sampling.
        :param noise: testing hook: ``{"res": [T, n, n], "anc": [T, n],
            "pick": [n]}`` Gumbels (the t = 0 rows unused).
        :return: :class:`CSMCResult`.
        """
        if ancestor_sampling and self._transition_log_prob is None:
            raise ValueError(
                "ancestor_sampling=True needs transition_log_prob; pass "
                "ancestor_sampling=False for plain (slower-mixing) cSMC.")
        T, device = self._series(ys)
        n = self._n
        if noise is None:
            key = as_key(key)

        def gen_for(s):
            return (None if noise is not None
                    else iteration_generator(key, s, device))

        def pin(a, r):
            return torch.cat([r[None].to(a.dtype), a[1:]], 0)

        x = self._init_fn(gen_for(0), n)
        x = tree_map(pin, x, tree_map(lambda a: a[0], ref))
        dtype = self._probe(x, ys)
        log_n = math.log(n)
        lw_n = torch.full((n,), -log_n, dtype=dtype, device=device)
        log_z = torch.zeros((), dtype=dtype, device=device)
        as_moves = torch.zeros((), dtype=torch.int32, device=device)
        hist, ancs = [], []
        for t in range(T):
            y = tree_map(lambda a: a[t], ys)
            if t > 0:
                gen = gen_for(t)
                ref_t = tree_map(lambda a: a[t], ref)
                g_res = _gumbels(noise, "res", gen, (n, n), dtype, device,
                                 index=(0, t))
                idx = torch.argmax(lw_n[None, :] + g_res, -1)
                if ancestor_sampling:
                    g_anc = _gumbels(noise, "anc", gen, (n,), dtype, device,
                                     index=(0, t))
                    lw_as = lw_n + self._transition_log_prob(ref_t, x, t)
                    a0 = torch.argmax(lw_as + g_anc, -1)
                else:
                    a0 = torch.zeros((), dtype=idx.dtype, device=device)
                idx = torch.cat([a0[None], idx[1:]])
                x_prev = tree_map(lambda a: a[idx], x)
                if self._proposal_fn is None:
                    x_new = self._transition_fn(gen, x_prev, t)
                else:
                    x_new = self._proposal_fn(gen, x_prev, y, t)
                x_new = tree_map(pin, x_new, ref_t)
                lw_inc = self._emission_log_prob(x_new, y, t)
                if self._proposal_fn is not None:
                    # Slot 0 gets the REFERENCE's correction (its forced
                    # value, its selected ancestor).
                    lw_inc = lw_inc + (
                        self._transition_log_prob(x_new, x_prev, t)
                        - self._proposal_log_prob(x_new, x_prev, y, t)
                    ).to(dtype)
                as_moves = as_moves + (a0 != 0).to(as_moves.dtype)
                x, anc = x_new, idx
            else:
                anc = torch.arange(n, device=device)
                lw_inc = self._emission_log_prob(x, y, t)
            # Multinomial resampling every step: the incoming weights are
            # uniform, the evidence increment the plain mean.
            lse = torch.logsumexp(lw_inc, 0)
            log_z = log_z + lse - log_n
            lw_n = lw_inc - lse
            hist.append(x)
            ancs.append(anc)

        g = _gumbels(noise, "pick", gen_for(T), (n,), dtype, device)
        j = torch.argmax(lw_n + g, -1)
        traj = []
        for t in range(T - 1, -1, -1):
            traj.append(tree_map(lambda a: a[j], hist[t]))
            j = ancs[t][j]
        return CSMCResult(trajectory=_tree_stack(traj[::-1]), log_z=log_z,
                          ancestor_moves=as_moves)


class ParticleGibbs:
    """Particle Gibbs (Andrieu, Doucet & Holenstein 2010): a conditional-SMC
    trajectory refresh alternating with a parameter update given the whole
    latent path; exact MCMC on ``p(theta, x_{0:T-1} | y_{0:T-1})``.

    :param make_filter: ``theta -> ParticleFilter`` factory.
    :param update_params: ``(gen, theta, trajectory) -> theta`` Gibbs /
        MH-within-Gibbs parameter update (``gen`` a ``torch.Generator``);
        None keeps ``theta`` fixed.
    :param ancestor_sampling: passed to
        :meth:`ParticleFilter.conditional_run`.
    """

    _VALID_FIELDS = ("params", "trajectory", "log_z", "ancestor_moves")

    def __init__(self, make_filter: Callable,
                 update_params: Optional[Callable] = None,
                 ancestor_sampling: bool = True):
        self._make_filter = make_filter
        self._update = update_params
        self._as = bool(ancestor_sampling)

    def run(self, key, ys, theta0: dict, ref0, n_sweeps: int,
            collect_fields=("params", "trajectory", "log_z"), *,
            noise=None):
        """``n_sweeps`` sweeps in a Python loop. Sweep ``i`` runs its cSMC
        under a key pair derived from ``(key, i)`` and gives
        ``update_params`` the generator ``iteration_generator(key, i + 1)``.

        :param theta0: initial parameter dict (any pytree).
        :param ref0: initial reference trajectory, leaves ``[T, ...]``.
        :param noise: testing hook: one ``(csmc_noise, update_noise)`` a
            sweep; ``update_noise`` goes to ``update_params`` in place of
            its generator.
        :return: ``(final_theta, final_trajectory, {field: stacked}``).
        """
        for f in collect_fields:
            if f not in self._VALID_FIELDS:
                raise ValueError("Unknown collect field {!r}; valid: {}."
                                 .format(f, self._VALID_FIELDS))
        _, device = ParticleFilter._series(ys)
        if noise is None:
            key = as_key(key)
        theta, ref = theta0, ref0
        out = {f: [] for f in collect_fields}
        for i in range(int(n_sweeps)):
            if noise is None:
                k_traj = child_key(key, i)
                k_par, nz = iteration_generator(key, i + 1, device), None
            else:
                k_traj, (nz, k_par) = None, noise[i]
            res = self._make_filter(theta).conditional_run(
                k_traj, ys, ref, ancestor_sampling=self._as, noise=nz)
            ref = res.trajectory
            if self._update is not None:
                theta = self._update(k_par, theta, ref)
            full = {"params": theta, "trajectory": ref, "log_z": res.log_z,
                    "ancestor_moves": res.ancestor_moves}
            for f in collect_fields:
                out[f].append(full[f])
        return theta, ref, {f: _tree_stack(v) for f, v in out.items()}


# -- pseudo-marginal MH (PMMH) --------------------------------------------


class PMMHState(NamedTuple):
    """Pseudo-marginal Metropolis state (``mcmc/rwm.py``'s conventions;
    ``t`` a host int): the RETAINED evidence estimate rides with the
    parameters, filled with a NaN sentinel at init (``sample`` re-estimates
    on it)."""

    theta: Any  # parameter dict, leaves [n_chains, ...]
    log_post: torch.Tensor  # [n_chains] retained log_z_hat + log_prior
    t: int
    step_size: torch.Tensor  # scalar
    da_step: torch.Tensor
    h_bar: torch.Tensor
    log_epsilon_bar: torch.Tensor

    def invalidate_cache(self) -> "PMMHState":
        """Mark the retained evidence stale; the next ``sample`` refills
        it."""
        return self._replace(log_post=torch.full_like(self.log_post,
                                                      float("nan")))


class PMMHInfo(NamedTuple):
    """Per-iteration statistics."""

    samples: Any
    acceptance_rate: torch.Tensor  # [n_chains]
    updated_step_size: torch.Tensor
    log_post: torch.Tensor  # [n_chains] retained log-posterior estimate


class PseudoMarginalMH:
    """Particle-marginal / pseudo-marginal Metropolis-Hastings (Andrieu,
    Doucet & Holenstein 2010): random-walk MH over model parameters with the
    likelihood replaced by an unbiased stochastic estimate (for
    state-space models, the particle filter's ``log_z``); the retained
    estimate makes it target the exact parameter posterior.

    The chains run as ONE batch: ``log_z_fn`` runs under
    ``torch.func.vmap(..., randomness="different")`` over the chain axis,
    so a filter inside it must not read the device (the port's
    :class:`ParticleFilter` does not).

    :param log_z_fn: ``(theta_single, key) -> scalar`` unbiased
        log-evidence estimator for ONE parameter setting, ``key`` a Philox
        key pair shared by the chains (each draws its own numbers under
        ``vmap``). Typically ``lambda th, k: make_filter(th).run(k,
        ys).log_z``.
    :param log_prior: ``(theta_single) -> scalar`` parameter log-prior.
    :param step_size: random-walk proposal scale (times
        ``proposal_scales``).
    :param proposal_scales: optional dict of per-site scales.
    :param adapt_step_size: dual-average the step size toward
        ``target_acceptance_rate`` during ``run``'s ``n_adapt`` window.
    """

    _VALID_FIELDS = ("samples", "acceptance_rate", "step_size", "log_post")

    def __init__(
        self,
        log_z_fn: Callable,
        log_prior: Callable,
        step_size: float = 0.1,
        proposal_scales: Optional[dict] = None,
        adapt_step_size: bool = False,
        target_acceptance_rate: float = 0.234,
        gamma: float = 0.05,
        t0: float = 100.0,
        kappa: float = 0.75,
    ):
        if not float(step_size) > 0.0:
            raise ValueError("step_size must be positive.")
        if not 0.0 < float(target_acceptance_rate) < 1.0:
            raise ValueError("target_acceptance_rate must be in (0, 1).")
        self._log_z_fn = log_z_fn
        self._log_prior = log_prior
        self._step_size = float(step_size)
        self._scales = dict(proposal_scales or {})
        self._adapt = bool(adapt_step_size)
        self._target = float(target_acceptance_rate)
        self._gamma, self._t0, self._kappa = (float(gamma), float(t0),
                                              float(kappa))

    def init(self, theta: dict) -> PMMHState:
        """State from initial parameters, every leaf ``[n_chains, ...]``."""
        theta = {k: torch.as_tensor(v) for k, v in theta.items()}
        any_leaf = next(iter(theta.values()))
        n_chains = any_leaf.shape[0]
        dtype, device = any_leaf.dtype, any_leaf.device
        zero = torch.zeros((), dtype=dtype, device=device)
        return PMMHState(
            theta=theta,
            log_post=torch.full((n_chains,), float("nan"), dtype=dtype,
                                device=device),
            t=0,
            step_size=torch.full((), self._step_size, dtype=dtype,
                                 device=device),
            da_step=zero, h_bar=zero, log_epsilon_bar=zero)

    def _estimate(self, theta, key, per_chain):
        """[n_chains] log_z_hat + log_prior: one vmapped batch over the
        chain axis. ``key`` is a key pair shared by the chains, or (with
        ``per_chain``) a pytree with a leading chain axis handed to
        ``log_z_fn`` chain by chain (the testing hook)."""

        def one(th, k):
            return self._log_z_fn(th, k) + self._log_prior(th)

        with torch.no_grad():
            if per_chain:
                return torch.func.vmap(one, randomness="different")(theta,
                                                                    key)
            return torch.func.vmap(lambda th: one(th, key),
                                   randomness="different")(theta)

    def sample(self, state: PMMHState, key=None, adapt=None, *, noise=None):
        """One pseudo-marginal MH step over all chains.

        Each call consumes ONE evidence estimate per chain (the proposal's);
        the current position's is RETAINED. The NaN sentinel is tested on
        the host (one read). Iteration ``t`` draws the proposal normals
        (sorted-name order) and the MH uniforms from
        ``iteration_generator(key, t)``; the estimates run under key pairs
        derived from ``(key, t)``.

        :param noise: testing hook: ``(fill, eps, z, u)``: the refill's and
            the proposal's per-chain ``log_z_fn`` keys (pytrees with a
            leading chain axis), the proposal normals (a dict like
            ``theta``) and the ``[n_chains]`` MH uniforms.
        """
        t = state.t + 1
        dtype, device = state.log_post.dtype, state.log_post.device
        if noise is None:
            key = as_key(key)
            gen = iteration_generator(key, t, device)
            k_fill, k_z, eps, u = (child_key(key, t, 1), child_key(key, t, 2),
                                   None, None)
        else:
            gen = None
            k_fill, eps, k_z, u = noise
            eps = {k: torch.as_tensor(v) for k, v in eps.items()}
        per_chain = noise is not None
        log_post0 = state.log_post
        if bool(torch.isnan(log_post0).any()):
            log_post0 = self._estimate(state.theta, k_fill,
                                       per_chain).to(dtype)
        eps = tree_normal_like(gen, state.theta, eps)
        theta_prop = {
            n: state.theta[n] + state.step_size * torch.as_tensor(
                self._scales.get(n, 1.0), dtype=state.theta[n].dtype,
                device=state.theta[n].device) * eps[n]
            for n in state.theta}
        log_post_prop = self._estimate(theta_prop, k_z, per_chain).to(dtype)
        with torch.no_grad():
            # NaN / -inf proposals are rejected; +inf escapes stay accepts.
            log_alpha = log_post_prop - log_post0
            bad = torch.isnan(log_alpha) | ~torch.isfinite(log_post_prop)
            log_alpha = torch.where(bad, -math.inf, log_alpha)
            accept_rate = torch.clamp(
                torch.exp(torch.clamp(log_alpha, max=0.0)), max=1.0)
            if u is None:
                u = torch.rand(log_alpha.shape, generator=gen, dtype=dtype,
                               device=device)
            else:
                u = torch.as_tensor(u, dtype=dtype, device=device)
            accept = torch.log(u) < log_alpha
            theta = {n: _pick(accept, theta_prop[n], state.theta[n])
                     for n in state.theta}
            log_post = torch.where(accept, log_post_prop, log_post0)
            gate = self._adapt if adapt is None else adapt
            step_size, da_step, h_bar, log_eps_bar = dual_averaging_update(
                state.da_step, state.h_bar, state.log_epsilon_bar,
                state.step_size, torch.mean(accept_rate), gate,
                fresh_start=state.t == 0,
                mu=float(np.log(10.0 * self._step_size)),
                target=self._target, gamma=self._gamma, t0=self._t0,
                kappa=self._kappa)
        ss_dtype = state.step_size.dtype
        new_state = PMMHState(
            theta=theta, log_post=log_post, t=t,
            step_size=step_size.to(ss_dtype),
            da_step=da_step.to(state.da_step.dtype),
            h_bar=h_bar.to(ss_dtype),
            log_epsilon_bar=log_eps_bar.to(ss_dtype))
        return new_state, PMMHInfo(samples=theta, acceptance_rate=accept_rate,
                                   updated_step_size=new_state.step_size,
                                   log_post=log_post)

    def run(self, state: PMMHState, key, n_iters: int, n_adapt: int = 0,
            collect_fields=("samples", "acceptance_rate", "step_size",
                            "log_post"), *, noise=None):
        """``n_iters`` iterations in a Python loop over :meth:`sample`
        (each one vmapped batch of filters). Adaptation gates on the
        persisted ``state.t < n_adapt``.

        :param noise: testing hook: one :meth:`sample` ``noise`` a
            iteration.
        :return: ``(final_state, {field: [n_iters, ...] stacked})``.
        """
        for f in collect_fields:
            if f not in self._VALID_FIELDS:
                raise ValueError("Unknown collect field {!r}; valid: {}."
                                 .format(f, self._VALID_FIELDS))
        key = None if noise is not None else as_key(key)
        adapt_on = self._adapt and n_adapt > 0
        out = {f: [] for f in collect_fields}
        for i in range(int(n_iters)):
            gate = adapt_on and state.t < n_adapt
            state, info = self.sample(
                state, key, adapt=gate,
                noise=None if noise is None else noise[i])
            full = {"samples": info.samples,
                    "acceptance_rate": info.acceptance_rate,
                    "step_size": info.updated_step_size,
                    "log_post": info.log_post}
            for f in collect_fields:
                out[f].append(full[f])
        return state, {f: _tree_stack(v) for f, v in out.items()}


# -- the log-depth scan -----------------------------------------------------


def _interleave(a, b):
    """``[a0, b0, a1, b1, ...]`` along axis 0 (``len(a) - len(b)`` is 0 or
    1)."""
    if a.shape[0] == b.shape[0]:
        return torch.stack([a, b], 1).reshape((-1,) + tuple(a.shape[1:]))
    head = torch.stack([a[:-1], b], 1).reshape((-1,) + tuple(a.shape[1:]))
    return torch.cat([head, a[-1:]], 0)


def _associative_scan(fn, elems):
    """Inclusive prefix scan of an associative ``fn`` over axis 0 of
    ``elems`` (a tensor or a tuple of tensors of one length), in
    O(log T) depth: the odd/even recursion of ``jax.lax.associative_scan``
    (Blelloch 1990), so ``fn`` sees the same operand pairs in the same
    order. ``fn(a, b)`` combines an earlier ``a`` with a later ``b``,
    batched over the leading axis. Differentiable."""
    single = isinstance(elems, torch.Tensor)
    leaves = (elems,) if single else tuple(elems)

    def combine(a, b):
        if a[0].shape[0] == 0:
            return tuple(x[:0] for x in a)
        out = fn(a[0], b[0]) if single else fn(tuple(a), tuple(b))
        return (out,) if single else tuple(out)

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        reduced = combine(tuple(e[0:-1:2] for e in es),
                          tuple(e[1::2] for e in es))
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine(tuple(e[:-1] for e in odd),
                           tuple(e[2::2] for e in es))
        else:
            even = combine(odd, tuple(e[2::2] for e in es))
        even = tuple(torch.cat([e[:1], r], 0) for e, r in zip(es, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(leaves)
    return out[0] if single else out


def _suffix_scan(combine, elems):
    """Suffix combinations ``s_t = e_t * ... * e_{T-1}`` of an operator
    written for time order (left = earlier): a prefix
    :func:`_associative_scan` over the flipped elements with swapped
    operands."""
    single = isinstance(elems, torch.Tensor)
    flipped = (torch.flip(elems, [0]) if single
               else tuple(torch.flip(x, [0]) for x in elems))
    out = _associative_scan(lambda u, v: combine(v, u), flipped)
    return (torch.flip(out, [0]) if single
            else tuple(torch.flip(x, [0]) for x in out))


# -- discrete-state HMMs (exact) ------------------------------------------
#
# Emissions enter as a precomputed [T, K] table of per-state observation
# log-likelihoods, so any emission model plugs in. The sequential paths are
# Python loops over time of [K] / [K, K] dense algebra; parallel=True makes
# them log-depth scans of [K, K] log-space matmuls.


def _use_scan(parallel, x) -> bool:
    """Whether to take the log-depth scan: ``parallel`` when it is a bool;
    for None, whether ``x`` lies on a CUDA device. On an H100 80GB HBM3 the
    scan ran the HMM (K = 64) and Kalman (d = 4) passes 140-340x faster
    than the sequential loops at T = 16384, which launch ~20-30 small
    kernels a step (``chip_smoke.py`` phase 34, ``PERF.md``); on the CPU
    the sequential loop is the JAX package's default path."""
    return x.is_cuda if parallel is None else bool(parallel)


def _check_hmm(log_pi0, log_trans, log_obs):
    log_pi0, log_trans, log_obs = map(torch.as_tensor,
                                      (log_pi0, log_trans, log_obs))
    K = log_pi0.shape[-1]
    if tuple(log_trans.shape) != (K, K):
        raise ValueError("log_trans must be [K, K]={}, got {}.".format(
            (K, K), tuple(log_trans.shape)))
    if log_obs.ndim != 2 or log_obs.shape[1] != K:
        raise ValueError("log_obs must be [T, K] with K={}, got {}.".format(
            K, tuple(log_obs.shape)))
    return log_pi0, log_trans, log_obs


def _log_matmul(A, B):
    """Batched log-space matmul ``C[.., i, j] = LSE_k A[.., i, k] + B[.., k,
    j]``, max-shifted so the inner product is a real matmul; ``-inf`` rows /
    columns (impossible states) get a zero shift, so no ``inf - inf``."""
    a = torch.amax(A, dim=-1, keepdim=True)
    b = torch.amax(B, dim=-2, keepdim=True)
    a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
    b = torch.where(torch.isfinite(b), b, torch.zeros_like(b))
    prod = torch.exp(A - a) @ torch.exp(B - b)
    return torch.log(prod) + a + b


def _hmm_elems(log_pi0, log_trans, log_obs):
    """Per-step operators ``M_0[i, j] = log pi0[j] + obs[0, j]`` (constant
    over ``i``), ``M_t[i, j] = log_trans[i, j] + obs[t, j]``."""
    K = log_pi0.shape[-1]
    elems = log_trans[None] + log_obs[1:, None, :]
    first = (log_pi0 + log_obs[0]).expand(K, K)
    return torch.cat([first[None], elems], 0)


def hmm_filter(log_pi0, log_trans, log_obs,
               parallel: Optional[bool] = None):
    """Exact forward filtering for a discrete-state HMM.

    Convention: ``log_trans[i, j] = log p(x_t = j | x_{t-1} = i)``;
    ``log_obs[t, k] = log p(y_t | x_t = k)``. With ``parallel=True`` the
    recursion is a log-depth :func:`_associative_scan` over the ``[K, K]``
    step operators (O(T K^3) work instead of O(T K^2) sequential steps);
    ``None`` takes it on a CUDA device (:func:`_use_scan`).

    :return: ``(log_alpha, log_z)``: normalized filtering log-marginals
        ``[T, K]`` and the exact data log-likelihood.
    """
    log_pi0, log_trans, log_obs = _check_hmm(log_pi0, log_trans, log_obs)
    if _use_scan(parallel, log_obs):
        prefix = _associative_scan(_log_matmul,
                                   _hmm_elems(log_pi0, log_trans, log_obs))
        raw = prefix[:, 0, :]  # row 0: M_0 is constant over i
        c = torch.logsumexp(raw, 1)
        return raw - c[:, None], c[-1]
    a0 = log_pi0 + log_obs[0]
    c0 = torch.logsumexp(a0, 0)
    log_a, log_z = a0 - c0, c0
    out = [log_a]
    for t in range(1, log_obs.shape[0]):
        pred = torch.logsumexp(log_a[:, None] + log_trans, 0)
        post = pred + log_obs[t]
        c = torch.logsumexp(post, 0)
        log_a, log_z = post - c, log_z + c
        out.append(log_a)
    return torch.stack(out), log_z


def _hmm_backward(log_trans, log_obs, parallel: Optional[bool] = None):
    """Backward messages ``log_beta[t, i] = log p(y_{t+1:T-1} | x_t = i)``
    (unnormalized; ``log_beta[T-1] = 0``)."""
    K = log_trans.shape[-1]
    zero = torch.zeros((1, K), dtype=log_obs.dtype, device=log_obs.device)
    if log_obs.shape[0] == 1:
        return zero
    if _use_scan(parallel, log_obs):
        # beta_t[i] = LSE_j (N_{t+1} ... N_{T-1})[i, j], N_t[i, j] =
        # trans[i, j] + obs[t, j].
        suffix = _suffix_scan(_log_matmul,
                              log_trans[None] + log_obs[1:, None, :])
        return torch.cat([torch.logsumexp(suffix, 2), zero], 0)
    log_b = zero[0]
    out = []
    for t in range(log_obs.shape[0] - 1, 0, -1):
        log_b = torch.logsumexp(log_trans + (log_obs[t] + log_b)[None, :], 1)
        out.append(log_b)
    return torch.cat([torch.stack(out[::-1]), zero], 0)


def hmm_smoother(log_pi0, log_trans, log_obs,
                 parallel: Optional[bool] = None):
    """Exact forward-backward smoothing (both passes log-depth under
    ``parallel=True``, and under None on a CUDA device).

    :return: ``(log_gamma, log_z)``: normalized smoothing log-marginals
        ``[T, K]`` and the data log-likelihood.
    """
    log_alpha, log_z = hmm_filter(log_pi0, log_trans, log_obs,
                                  parallel=parallel)
    log_pi0, log_trans, log_obs = _check_hmm(log_pi0, log_trans, log_obs)
    post = log_alpha + _hmm_backward(log_trans, log_obs, parallel)
    return post - torch.logsumexp(post, 1, keepdim=True), log_z


class HMMStats(NamedTuple):
    """E-step sufficient statistics from :func:`hmm_expected_stats`."""

    log_gamma: torch.Tensor  # [T, K] smoothing log-marginals (normalized)
    log_xi: torch.Tensor  # [T-1, K, K] pairwise log p(x_t=i, x_{t+1}=j | y)
    log_z: torch.Tensor  # scalar data log-likelihood


def hmm_expected_stats(log_pi0, log_trans, log_obs,
                       parallel: Optional[bool] = None) -> HMMStats:
    """E-step of Baum-Welch: smoothing marginals, pairwise transition
    marginals and the data log-likelihood, in one forward and one backward
    pass. Emission models stay the caller's (fit them from
    ``exp(log_gamma)``)."""
    log_pi0, log_trans, log_obs = _check_hmm(log_pi0, log_trans, log_obs)
    if log_obs.shape[0] < 2:
        raise ValueError("hmm_expected_stats requires T >= 2.")
    log_alpha, log_z = hmm_filter(log_pi0, log_trans, log_obs,
                                  parallel=parallel)
    log_beta = _hmm_backward(log_trans, log_obs, parallel)
    post = log_alpha + log_beta
    log_gamma = post - torch.logsumexp(post, 1, keepdim=True)
    # xi_t[i, j] ~ alpha_t[i] + trans[i, j] + obs[t+1, j] + beta_{t+1}[j]
    raw = (log_alpha[:-1, :, None] + log_trans[None]
           + (log_obs[1:] + log_beta[1:])[:, None, :])
    log_xi = raw - torch.logsumexp(raw.flatten(1), 1)[:, None, None]
    return HMMStats(log_gamma=log_gamma, log_xi=log_xi, log_z=log_z)


def hmm_mstep(stats: HMMStats):
    """Closed-form M-step for the chain parameters.

    :return: ``(log_pi0, log_trans)``: ``pi0 = gamma_0``, ``trans[i, j] ~
        sum_t xi_t[i, j]`` row-normalized.
    """
    rows = torch.logsumexp(stats.log_xi, 0)
    return (stats.log_gamma[0],
            rows - torch.logsumexp(rows, 1, keepdim=True))


def hmm_posterior_sample(key, log_pi0, log_trans, log_obs, n_paths: int, *,
                         noise=None):
    """Joint posterior state paths ``x_{0:T-1} ~ p(x | y)`` by forward
    filtering / backward sampling (exact), the paths a batch axis.

    :param key: a ``torch.Generator`` or a Philox key pair.
    :param noise: testing hook: ``{"last": [n_paths, K], "back": [n_paths,
        T-1, K]}`` Gumbels, ``back`` in reversed time order.
    :return: ``[n_paths, T]`` int64 state paths.
    """
    log_alpha, _ = hmm_filter(log_pi0, log_trans, log_obs)
    log_pi0, log_trans, log_obs = _check_hmm(log_pi0, log_trans, log_obs)
    T, K = log_obs.shape
    P = int(n_paths)
    dtype, device = log_alpha.dtype, log_alpha.device
    if noise is None:
        key = as_key(key)

    def gen_for(s):
        return None if noise is not None else iteration_generator(key, s,
                                                                  device)

    g = _gumbels(noise, "last", gen_for(0), (P, K), dtype, device)
    x = torch.argmax(log_alpha[T - 1] + g, -1)
    out = [x]
    for s, t in enumerate(range(T - 2, -1, -1)):
        g = _gumbels(noise, "back", gen_for(s + 1), (P, K), dtype, device,
                     index=(1, s))
        x = torch.argmax(log_alpha[t] + log_trans[:, x].T + g, -1)
        out.append(x)
    return torch.stack(out[::-1], 1)


def hmm_viterbi(log_pi0, log_trans, log_obs):
    """Most probable state path (max-product dynamic programming).

    :return: ``(path, score)``: the ``[T]`` int64 argmax path and its joint
        log-probability ``log p(x*, y)``.
    """
    log_pi0, log_trans, log_obs = _check_hmm(log_pi0, log_trans, log_obs)
    delta = log_pi0 + log_obs[0]
    args = []
    for t in range(1, log_obs.shape[0]):
        best, arg = torch.max(delta[:, None] + log_trans, 0)
        delta = best + log_obs[t]
        args.append(arg)
    score, x = torch.max(delta, 0)
    path = [x]
    for arg in reversed(args):
        x = arg[x]
        path.append(x)
    return torch.stack(path[::-1]), score


# -- exact linear-Gaussian baseline ---------------------------------------


class KalmanResult(NamedTuple):
    """Output of :func:`kalman_filter` / :func:`kalman_smoother`."""

    means: torch.Tensor  # [T, d] filtering (or smoothing) means
    covs: torch.Tensor  # [T, d, d] matching covariances
    log_likelihood: torch.Tensor  # scalar log p(y_{0:T-1}) (exact)


def _cholesky(M):
    """Lower Cholesky factor with no host sync (``cholesky_ex``; a failed
    factorization shows as NaN downstream, as in the JAX package)."""
    return torch.linalg.cholesky_ex(M).L


def _cho_solve(chol, B):
    """``(L L')^{-1} B`` from the lower factor by two triangular solves
    (``jax.scipy.linalg.cho_solve``'s; ``torch.cholesky_solve`` reads its
    status back on the host)."""
    z = torch.linalg.solve_triangular(chol, B, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), z,
                                         upper=True)


def _solve(A, B):
    """``A^{-1} B`` batched, with no host sync (``solve_ex``)."""
    return torch.linalg.solve_ex(A, B).result


def _mvn_logpdf_chol(y, mean, chol):
    """log N(y; mean, L L') from the lower factor ``chol``, batched over
    leading axes."""
    d = y.shape[-1]
    z = torch.linalg.solve_triangular(chol, (y - mean)[..., None],
                                      upper=False)[..., 0]
    half_log_det = torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                      dim2=-1)), -1)
    return (-0.5 * torch.sum(z ** 2, -1) - half_log_det
            - 0.5 * d * math.log(2.0 * math.pi))


def _mvn_logpdf(y, mean, cov):
    return _mvn_logpdf_chol(y, mean, _cholesky(cov))


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    """Batched matrix-vector product ``M[..., i, j] v[..., j]``."""
    return (M @ v[..., None])[..., 0]


def _kalman_combine(ei, ej):
    """Associative combination of two Kalman filtering elements ``(A, b, C,
    eta, J)`` (earlier ``ei``, later ``ej``): the temporal-parallelization
    operator of Sarkka & Garcia-Fernandez (IEEE TAC 2021, eq. 10), batched
    over the leading axis."""
    Ai, bi, Ci, ni, Ji = ei
    Aj, bj, Cj, nj, Jj = ej
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    D = eye + Ci @ Jj
    Dt = eye + Jj @ Ci
    sol_A = _solve(D, Ai)
    sol_b = _solve(D, (bi + _mv(Ci, nj))[..., None])[..., 0]
    sol_C = _solve(D, Ci)
    AiT = Ai.transpose(-1, -2)
    sol_n = _solve(Dt, (nj - _mv(Jj, bi))[..., None])[..., 0]
    sol_J = _solve(Dt, Jj)
    return (
        Aj @ sol_A,
        _mv(Aj, sol_b) + bj,
        _sym(Aj @ sol_C @ Aj.transpose(-1, -2) + Cj),
        _mv(AiT, sol_n) + ni,
        _sym(AiT @ sol_J @ Ai + Ji),
    )


def _kalman_filter_parallel(ys, A, Q, H, R, m0, P0) -> KalmanResult:
    """Log-depth Kalman filter: per-step conditional-density elements
    combined by :func:`_kalman_combine` under one :func:`_associative_scan`;
    the prefix element's ``(b, C)`` is the filtering ``(mean, cov)``; the
    log-likelihood comes afterwards from the one-step-ahead predictives."""
    T, d = ys.shape[0], m0.shape[0]
    eye = torch.eye(d, dtype=ys.dtype, device=ys.device)

    # Generic element (t >= 1): S, K and the squares are t-independent.
    S = H @ Q @ H.T + R
    chol_s = _cholesky(S)
    K = _cho_solve(chol_s, H @ Q.T).T
    A_g = (eye - K @ H) @ A
    C_g = _sym((eye - K @ H) @ Q)
    W = _cho_solve(chol_s, H @ A)  # S^{-1} H A
    eta_g = ys[1:] @ W  # [T-1, d]: eta_t = A' H' S^{-1} y_t
    J_g = _sym(W.T @ (H @ A))  # A' H' S^{-1} H A

    # First element: the prior (x_0 ~ N(m0, P0), no transition).
    S0 = H @ P0 @ H.T + R
    K0 = _cho_solve(_cholesky(S0), H @ P0.T).T
    b0 = m0 + K0 @ (ys[0] - H @ m0)
    C0 = _sym((eye - K0 @ H) @ P0)

    zeros_m = torch.zeros((1, d, d), dtype=ys.dtype, device=ys.device)
    elems = (
        torch.cat([zeros_m, A_g.expand(T - 1, d, d)], 0),
        torch.cat([b0[None], ys[1:] @ K.T], 0),
        torch.cat([C0[None], C_g.expand(T - 1, d, d)], 0),
        torch.cat([torch.zeros((1, d), dtype=ys.dtype, device=ys.device),
                   eta_g], 0),
        torch.cat([zeros_m, J_g.expand(T - 1, d, d)], 0),
    )
    _, ms, Ps, _, _ = _associative_scan(_kalman_combine, elems)

    # Exact log-likelihood from the one-step-ahead predictives, batched.
    m_pred = torch.cat([m0[None], ms[:-1] @ A.T], 0)
    P_pred = torch.cat([P0[None], _sym(A @ Ps[:-1] @ A.T + Q)], 0)
    S_all = H @ P_pred @ H.T + R
    ll = torch.sum(_mvn_logpdf(ys, m_pred @ H.T, S_all))
    return KalmanResult(means=ms, covs=Ps, log_likelihood=ll)


def kalman_filter(ys, A, Q, H, R, m0, P0,
                  parallel: Optional[bool] = None) -> KalmanResult:
    """Exact filter for the linear-Gaussian SSM

    .. math::
        x_0 \\sim N(m_0, P_0), \\quad
        x_t = A x_{t-1} + N(0, Q), \\quad
        y_t = H x_t + N(0, R).

    A Python loop over time with Cholesky-based innovations (no explicit
    inverses, no host sync). With ``parallel=True`` the recursion is the
    temporal-parallelization associative scan (Sarkka & Garcia-Fernandez,
    IEEE TAC 2021): O(log T) depth, the same result to float tolerance;
    ``None`` takes it on a CUDA device (:func:`_use_scan`).

    :param ys: ``[T, p]`` observations.
    :param A: ``[d, d]`` transition matrix.
    :param Q: ``[d, d]`` transition noise covariance.
    :param H: ``[p, d]`` emission matrix.
    :param R: ``[p, p]`` emission noise covariance.
    :param m0: ``[d]`` initial mean.
    :param P0: ``[d, d]`` initial covariance.
    """
    ys, A, Q, H, R, m0, P0 = map(torch.as_tensor, (ys, A, Q, H, R, m0, P0))
    if _use_scan(parallel, ys):
        return _kalman_filter_parallel(ys, A, Q, H, R, m0, P0)
    m, P = m0, P0
    ms, Ps, mean_ys, chols = [], [], [], []
    for t in range(ys.shape[0]):
        if t > 0:  # predict (m0 / P0 already describe x_0)
            m, P = A @ m, A @ P @ A.T + Q
        S = H @ P @ H.T + R
        chol_s = _cholesky(S)
        mean_y = H @ m
        # K = P H' S^{-1} by two triangular solves.
        K = _cho_solve(chol_s, H @ P.T).T
        m = m + K @ (ys[t] - mean_y)
        P = P - K @ S @ K.T
        ms.append(m)
        Ps.append(P)
        mean_ys.append(mean_y)
        chols.append(chol_s)
    # The innovations' densities in one batch after the loop.
    ll = torch.sum(_mvn_logpdf_chol(ys, torch.stack(mean_ys),
                                    torch.stack(chols)))
    return KalmanResult(means=torch.stack(ms), covs=torch.stack(Ps),
                        log_likelihood=ll)


def kalman_smoother(ys, A, Q, H, R, m0, P0,
                    parallel: Optional[bool] = None) -> KalmanResult:
    """Rauch-Tung-Striebel smoother for the same model as
    :func:`kalman_filter`: the filter, then one backward loop; smoothing
    means / covariances with the filter's exact log-likelihood.

    ``parallel=True`` runs both passes as log-depth scans: the backward
    elements ``(E, g, L) = (G_t, m_t - G_t A m_t, P_t - G_t P^-_{t+1} G_t')``
    combine as ``(E_i E_j, g_i + E_i g_j, L_i + E_i L_j E_i')``; ``None``
    takes them on a CUDA device (:func:`_use_scan`)."""
    ys, A, Q, H, R, m0, P0 = map(torch.as_tensor, (ys, A, Q, H, R, m0, P0))
    parallel = _use_scan(parallel, ys)
    filt = kalman_filter(ys, A, Q, H, R, m0, P0, parallel=parallel)
    ms, Ps = filt.means, filt.covs
    T = ys.shape[0]
    if parallel:
        if T == 1:
            return filt
        P_pred = _sym(A @ Ps[:-1] @ A.T + Q)  # [T-1, d, d]
        G = _solve(P_pred, A @ Ps[:-1].transpose(-1, -2)).transpose(-1, -2)
        g = ms[:-1] - _mv(G, ms[:-1] @ A.T)
        L = _sym(Ps[:-1] - G @ P_pred @ G.transpose(-1, -2))
        d = m0.shape[0]
        elems = (
            torch.cat([G, torch.zeros((1, d, d), dtype=ys.dtype,
                                      device=ys.device)], 0),
            torch.cat([g, ms[-1][None]], 0),
            torch.cat([L, Ps[-1][None]], 0),
        )

        def combine(ei, ej):
            Ei, gi, Li = ei
            Ej, gj, Lj = ej
            return (Ei @ Ej, gi + _mv(Ei, gj),
                    _sym(Li + Ei @ Lj @ Ei.transpose(-1, -2)))

        _, ms_s, Ps_s = _suffix_scan(combine, elems)
        return KalmanResult(means=ms_s, covs=Ps_s,
                            log_likelihood=filt.log_likelihood)
    m_s, P_s = ms[T - 1], Ps[T - 1]
    out_m, out_P = [m_s], [P_s]
    for t in range(T - 2, -1, -1):
        m_f, P_f = ms[t], Ps[t]
        m_pred = A @ m_f
        P_pred = A @ P_f @ A.T + Q
        # G = P_f A' P_pred^{-1}
        G = _cho_solve(_cholesky(P_pred), A @ P_f.T).T
        m_s = m_f + G @ (m_s - m_pred)
        P_s = P_f + G @ (P_s - P_pred) @ G.T
        out_m.append(m_s)
        out_P.append(P_s)
    return KalmanResult(means=torch.stack(out_m[::-1]),
                        covs=torch.stack(out_P[::-1]),
                        log_likelihood=filt.log_likelihood)
