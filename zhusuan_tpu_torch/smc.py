"""Annealed sequential Monte Carlo (Del Moral, Doucet & Jasra 2006); port
of ``zhusuan_tpu/smc.py``.

A population of particles follows the tempered bridge ``log f_beta =
(1-beta) log_prior + beta log_joint`` from the proposal to the posterior:
each temperature reweights (elementwise + logsumexp), resamples
systematically when the effective sample size collapses, and rejuvenates
with MCMC moves that leave ``f_beta`` invariant. The run returns an
unbiased evidence estimate ``log Z`` and an equally weighted posterior
particle set.

The JAX package runs the ladder as one ``lax.scan`` (``lax.while_loop``
for adaptive tempering). Here the ladder is a Python loop over the
temperatures and every step stays on the device:

- the resampling decision is a device select (``torch.where`` on ``ess <
  threshold * n``): the resampled cloud is always computed, as JAX draws
  its resampling key either way, so no step reads the device;
- the rejuvenation kernel (RWM, MALA or HMC, adaptation off) advances
  through its own ``sample``. The tempered density is a closure, which HMC
  runs on its plain transition, unless the target is a built-in density
  and ``prior_density=`` names the proposal's as one: the moves then get a
  :class:`~zhusuan_tpu_torch.ops.densities.TemperedLogJoint` whose
  ``beta`` is the ladder's device scalar, and HMC runs each move in one
  launch of its CUDA kernel (K1), as JAX traces the closure into K1 on a
  TPU;
- :meth:`AnnealedSMC.run_adaptive` reads ONE value a temperature, ``beta <
  1``, to end its loop; its 30 bisection halvings stay device ops.

``key`` is a ``torch.Generator`` or a Philox key pair
(:func:`~zhusuan_tpu_torch.ops._random.as_key`). Temperature ``i``
(1-based) draws its resampling uniform from ``iteration_generator(key,
i)``; its moves run under a key pair derived from ``(key, i)`` on the
host; the proposal's int seed comes from step 0 and the final
equal-weighting resample from the step after the last. ``noise=`` replaces
every draw (a testing hook; see :meth:`AnnealedSMC.run`).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Union

import torch

from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet
from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.mcmc.hmc import HMC
from zhusuan_tpu_torch.mcmc.rwm import FILL, USE, _MetropolisBase, _pick
from zhusuan_tpu_torch.ops._random import (
    as_key,
    child_key,
    iteration_generator,
)
from zhusuan_tpu_torch.ops.densities import (
    BuiltinDensity,
    TemperedLogJoint,
    check_builtin_gaps,
    check_tempered_pair,
)

__all__ = ["AnnealedSMC", "SMCResult"]

Latent = Dict[str, torch.Tensor]


class SMCResult(NamedTuple):
    """Output of :meth:`AnnealedSMC.run` / :meth:`~AnnealedSMC.run_adaptive`.
    """

    particles: Latent  # [n_particles, ...], equally weighted
    log_z: torch.Tensor  # scalar evidence estimate log p(observed)
    ess: torch.Tensor  # [n_steps_max] effective sample size per step
    n_resamples: torch.Tensor  # scalar int: resampling events
    acceptance_rate: torch.Tensor  # [n_steps_max] mean rejuvenation
    #                                acceptance at each temperature
    n_steps: int  # temperatures used (n_temperatures on the fixed
    #               schedule; <= max_steps + 1 adaptive), a host int
    betas: torch.Tensor  # realized ladder (NaN-padded for adaptive runs)


def _systematic_resample(generator, log_weights, u=None):
    """Systematic resampling indices from log-weights ``[n]`` (normalized
    inside): one uniform offset, ``n`` evenly spaced positions against the
    weight CDF (cumsum + ``torch.searchsorted``), clamped to ``n - 1``.

    :param generator: draws the offset when ``u`` is None.
    :param u: the offset, a uniform on [0, 1) (testing hook).
    """
    return systematic_indices(
        torch.exp(log_weights - torch.logsumexp(log_weights, 0)), generator,
        u)


def systematic_indices(w, generator, u=None, grid=None):
    """:func:`_systematic_resample` from normalized weights ``w [n]``;
    ``grid`` may carry ``arange(n)`` in ``w``'s dtype (made once a run)."""
    n = w.shape[0]
    cdf = torch.cumsum(w, 0)
    if u is None:
        u = torch.rand((), generator=generator, dtype=w.dtype,
                       device=w.device)
    else:
        u = torch.as_tensor(u, dtype=w.dtype, device=w.device)
    if grid is None:
        grid = torch.arange(n, dtype=w.dtype, device=w.device)
    return torch.clamp(torch.searchsorted(cdf, (grid + u) / n), 0, n - 1)


class AnnealedSMC:
    """Annealed SMC over the prior-to-posterior tempered bridge.

    Interface of :class:`zhusuan_tpu_torch.evaluation.AIS`: the proposal
    MetaBayesianNet supplies the initial particles and ``log_prior``; the
    latent chain shape must be the single particle axis ``[n_particles]``.

    :param meta_bn: target model (MetaBayesianNet or log-joint callable).
    :param proposal_meta_bn: proposal/prior MetaBayesianNet.
    :param kernel: a :class:`~zhusuan_tpu_torch.mcmc.RandomWalkMetropolis`,
        :class:`~zhusuan_tpu_torch.mcmc.MALA` or
        :class:`~zhusuan_tpu_torch.mcmc.HMC` instance used for rejuvenation
        (adaptation stays off inside the bridge).
    :param observed: observation dict for the target model.
    :param latent: latent names (list) or dict of names.
    :param n_temperatures: annealing steps (sigmoid schedule, AIS's shape).
    :param n_moves: rejuvenation MCMC steps per temperature.
    :param resample_threshold: resample when ESS < threshold * n.
    :param prior_density: the proposal's log-density as a built-in density
        (:mod:`~zhusuan_tpu_torch.ops.densities`), equal to
        ``proposal_meta_bn``'s up to a constant; the target ``meta_bn``
        must then be a built-in density over the same single latent. The
        moves then target a ``TemperedLogJoint`` of the two, which
        :class:`~zhusuan_tpu_torch.mcmc.HMC` runs in its CUDA kernel on the
        card. The reweighting keeps ``proposal_meta_bn``'s density.
    """

    def __init__(
        self,
        meta_bn,
        proposal_meta_bn: MetaBayesianNet,
        kernel: _MetropolisBase,
        observed: Dict,
        latent: Union[List[str], Dict],
        n_temperatures: int = 100,
        n_moves: int = 2,
        resample_threshold: float = 0.5,
        prior_density: Optional[BuiltinDensity] = None,
    ):
        self._log_joint = make_log_joint_fn(meta_bn, {})
        self._proposal = proposal_meta_bn
        self._log_prior = make_log_joint_fn(proposal_meta_bn, {})
        if not isinstance(kernel, (_MetropolisBase, HMC)):
            raise TypeError(
                "kernel must be a RandomWalkMetropolis, MALA or HMC "
                "instance, got {!r}.".format(type(kernel)))
        self._kernel = kernel
        self._observed = dict(observed)
        self._latent_names = (list(latent.keys()) if isinstance(latent, dict)
                              else list(latent))
        if int(n_temperatures) < 1:
            raise ValueError("n_temperatures must be >= 1.")
        self._n_temperatures = int(n_temperatures)
        if int(n_moves) < 0:
            raise ValueError("n_moves must be >= 0.")
        self._n_moves = int(n_moves)
        if not 0.0 <= float(resample_threshold) <= 1.0:
            raise ValueError("resample_threshold must be in [0, 1].")
        self._resample_threshold = float(resample_threshold)
        if prior_density is not None:
            self._builtin_pair = check_tempered_pair(
                prior_density, meta_bn, self._latent_names, self._observed)
        else:
            self._builtin_pair = None

    def _schedule(self, dtype, device):
        """Sigmoid temperatures in [0, 1] (AIS's ``evaluation.py:112-117``),
        computed in the particles' dtype as the JAX package does."""
        t = torch.arange(self._n_temperatures + 1, dtype=dtype, device=device)
        sig = torch.sigmoid(4.0 * (2.0 * t / self._n_temperatures - 1.0))
        return (sig - sig[0]) / (sig[-1] - sig[0])

    def _tempered(self, beta):
        """log f_beta(q) = (1-beta) log_prior + beta log_joint: the
        built-in bridge when ``prior_density`` was given, else a
        closure."""
        if self._builtin_pair is not None:
            return TemperedLogJoint(*self._builtin_pair, beta)

        def log_f(obs):
            q = {k: obs[k] for k in self._latent_names}
            lp0 = self._log_prior(q)
            lp1 = self._log_joint({**q, **self._observed})
            return (1.0 - beta) * lp0 + beta * lp1

        return log_f

    def _setup(self, key, noise):
        """The initial particles (the proposal's draw, or ``noise["init"]``)
        and their prior density, whose shape is checked: one evaluation in
        place of JAX's shape-only probe, reused by the first step."""
        if noise is not None:
            q0 = {k: torch.as_tensor(noise["init"][k])
                  for k in self._latent_names}
        else:
            seed = child_key(key, 0, salt=1)[0] & 0x7FFFFFFF
            bn = self._proposal.observe(key=seed)
            q0 = {name: torch.as_tensor(bn[name].tensor).detach()
                  for name in self._latent_names}
        with torch.no_grad():
            lp0 = self._log_prior(q0)
        if lp0.ndim != 1:
            raise ValueError(
                "AnnealedSMC supports a single particle axis: the proposal "
                "log-prior must be [n_particles]-shaped, got shape {}."
                .format(tuple(lp0.shape)))
        if self._builtin_pair is not None:
            # One read a run: the built-in must differ from the proposal's
            # density by a constant on the initial particles.
            with torch.no_grad():
                check_builtin_gaps(
                    [("prior_density", self._builtin_pair[0](q0), lp0)],
                    "initial particles")
        return q0, lp0

    def _move(self, log_f, q, key, noise):
        """``n_moves`` rejuvenation steps targeting ``log_f`` from a fresh
        kernel state; returns the new particles and the mean acceptance."""
        state = self._kernel.init(q, n_chain_dims=1)
        acc = None
        for m in range(self._n_moves):
            nz = None if noise is None else noise[m]
            if isinstance(self._kernel, HMC):
                # init_step_size_search=False suppresses HMC's heuristic
                # search on this fresh t = 0 state, which would make the
                # transition depend on the particle cloud.
                state, info = self._kernel.sample(
                    log_f, {}, state, None if nz is not None else key,
                    adapt_step_size=False, adapt_mass=False,
                    init_step_size_search=False, noise=nz)
            else:
                state, info = self._kernel._transition(
                    log_f, {}, state, key, False, nz,
                    FILL if m == 0 else USE)
            rate = torch.mean(info.acceptance_rate)
            acc = rate if acc is None else acc + rate
        return state.q, acc / self._n_moves

    def _bridge_step(self, q, log_w, log_z, n_resamples, key, step,
                     beta_prev, beta, lp0=None, lp1=None, noise=None):
        """One reweight -> conditional-resample -> rejuvenate step, shared
        by the fixed-schedule and adaptive drivers.

        ``lp0`` / ``lp1`` may carry the prior / joint densities at ``q``
        (the adaptive driver evaluated them to choose the temperature).
        ``noise`` is ``(u, moves)``: the resampling uniform and the
        kernel's ``noise`` for each move.
        """
        n = log_w.shape[0]
        dtype = log_w.dtype
        with torch.no_grad():
            if lp0 is None:
                lp0 = self._log_prior(q)
            if lp1 is None:
                lp1 = self._log_joint({**q, **self._observed})
            # 1. Reweight; the evidence takes the PREVIOUS normalized
            # weights.
            log_w_inc = (beta - beta_prev) * (lp1 - lp0)
            log_w = log_w - torch.logsumexp(log_w, 0) + log_w_inc
            inc = torch.logsumexp(log_w, 0)
            log_z = log_z + inc

            # 2. Systematic resampling on ESS collapse, as a device select
            # (``inc`` normalizes the new weights, as JAX's second
            # logsumexp of the same values does).
            lw_n = log_w - inc
            ess = torch.exp(-torch.logsumexp(2.0 * lw_n, 0))
            gen = (None if noise is not None
                   else iteration_generator(key, step, log_w.device))
            idx = systematic_indices(torch.exp(lw_n), gen,
                                     None if noise is None else noise[0])
            do = ess < self._resample_threshold * n
            q = {k: _pick(do, v[idx], v) for k, v in q.items()}
            log_w = torch.where(do, torch.full_like(log_w, -math.log(n)),
                                log_w)
            n_resamples = n_resamples + do.to(n_resamples.dtype)

        # 3. Rejuvenate with MCMC moves targeting f_beta.
        acc = torch.zeros((), dtype=dtype, device=log_w.device)
        if self._n_moves:
            q, acc = self._move(self._tempered(beta), q,
                                child_key(key, step) if noise is None
                                else None,
                                None if noise is None else noise[1])
            acc = acc.to(dtype)
        return q, log_w, log_z, n_resamples, ess, acc

    def _finish(self, q, log_w, key, step, noise):
        """The final equal-weighting resample."""
        gen = (None if noise is not None
               else iteration_generator(key, step, log_w.device))
        with torch.no_grad():
            idx = _systematic_resample(gen, log_w,
                                       None if noise is None
                                       else noise["final"])
        return {k: v[idx] for k, v in q.items()}

    def run(self, key=None, *, noise=None) -> SMCResult:
        """Run the fixed-schedule annealing pass: a Python loop over the
        sigmoid ladder with no host read.

        :param key: a ``torch.Generator`` or a Philox key pair (None: the
            default CPU generator's draw).
        :param noise: testing hook replacing every draw: ``{"init":
            {name: particles}, "steps": [(u, moves)] * n_temperatures,
            "final": u}``, ``u`` a resampling uniform and ``moves`` the
            kernel's ``noise`` tuples, one a move.
        """
        key = None if noise is not None else as_key(key)
        q, lp0 = self._setup(key, noise)
        n, dtype, device = lp0.shape[0], lp0.dtype, lp0.device
        schedule = self._schedule(dtype, device)
        log_w = torch.full((n,), -math.log(n), dtype=dtype, device=device)
        log_z = torch.zeros((), dtype=dtype, device=device)
        n_resamples = torch.zeros((), dtype=torch.int32, device=device)
        ess_t, acc_t = [], []
        for i in range(self._n_temperatures):
            q, log_w, log_z, n_resamples, ess, acc = self._bridge_step(
                q, log_w, log_z, n_resamples, key, i + 1, schedule[i],
                schedule[i + 1], lp0=lp0 if i == 0 else None,
                noise=None if noise is None else noise["steps"][i])
            ess_t.append(ess)
            acc_t.append(acc)
        particles = self._finish(q, log_w, key, self._n_temperatures + 1,
                                 noise)
        return SMCResult(
            particles=particles, log_z=log_z, ess=torch.stack(ess_t),
            n_resamples=n_resamples, acceptance_rate=torch.stack(acc_t),
            n_steps=self._n_temperatures, betas=schedule[1:])

    def run_adaptive(self, key=None, target_cess: float = 0.9,
                     max_steps: int = 200, n_bisect: int = 30,
                     *, noise=None) -> SMCResult:
        """Adaptive tempering: each increment ``delta`` is chosen by
        bisection so that the CONDITIONAL effective sample size of the
        incremental weights stays at ``target_cess * n`` (Jasra et al.
        2011).

        The loop is a Python loop that reads one value a temperature
        (``beta < 1``; the step count is a host int); the ``n_bisect``
        halvings are device ops; the per-step ESS / acceptance / beta go
        into NaN-filled ``[max_steps + 1]`` buffers. The ladder always ends
        at ``beta = 1``: if ``max_steps`` runs out first, one forced closing
        jump bridges the rest (one more read).

        :param noise: as :meth:`run`'s, ``"steps"`` holding one entry a
            temperature taken (the closing jump's last).
        :return: :class:`SMCResult` with ``n_steps`` the temperatures used
            and ``betas`` the realized ladder (NaN-padded).
        """
        if not 0.0 < float(target_cess) < 1.0:
            # 1.0 exactly is unattainable: CESS(delta) < n for every
            # delta > 0, so the ladder could never take a real step.
            raise ValueError("target_cess must be in (0, 1).")
        key = None if noise is not None else as_key(key)
        q, lp0 = self._setup(key, noise)
        n, dtype, device = lp0.shape[0], lp0.dtype, lp0.device
        log_n = math.log(n)
        log_target = torch.log(torch.tensor(float(target_cess) * n,
                                            dtype=dtype, device=device))
        one = torch.ones((), dtype=dtype, device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        buf_len = max_steps + 1
        ess_buf = torch.full((buf_len,), math.nan, dtype=dtype, device=device)
        acc_buf = torch.full_like(ess_buf, math.nan)
        beta_buf = torch.full_like(ess_buf, math.nan)
        log_w = torch.full((n,), -log_n, dtype=dtype, device=device)
        log_z = zero
        n_resamples = torch.zeros((), dtype=torch.int32, device=device)
        beta = zero

        def log_cess(lw_n, d, delta):
            # CESS = (sum W e^{delta d})^2 / sum W e^{2 delta d} * n
            a = torch.logsumexp(lw_n + delta * d, 0)
            b = torch.logsumexp(lw_n + 2.0 * delta * d, 0)
            return 2.0 * a - b + log_n

        def step_noise(i):
            return None if noise is None else noise["steps"][i]

        i = 0
        while i < max_steps and bool(beta < one):
            with torch.no_grad():
                lp0 = self._log_prior(q) if i > 0 else lp0
                lp1 = self._log_joint({**q, **self._observed})
                d = lp1 - lp0
                lw_n = log_w - torch.logsumexp(log_w, 0)
                hi0 = one - beta
                lo, hi = zero, hi0
                for _ in range(n_bisect):
                    mid = 0.5 * (lo + hi)
                    ok = log_cess(lw_n, d, mid) >= log_target
                    lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
                # The full remaining jump when it keeps the CESS above
                # target; never stall below 1/max_steps of the gap.
                delta = torch.where(log_cess(lw_n, d, hi0) >= log_target,
                                    hi0, lo)
                delta = torch.maximum(delta, hi0 / max_steps)
                new_beta = torch.minimum(beta + delta, one)
            q, log_w, log_z, n_resamples, ess, acc = self._bridge_step(
                q, log_w, log_z, n_resamples, key, i + 1, beta, new_beta,
                lp0=lp0, lp1=lp1, noise=step_noise(i))
            ess_buf[i] = ess
            acc_buf[i] = acc
            beta_buf[i] = new_beta
            beta = new_beta
            i += 1
        if bool(beta < one):
            # max_steps ran out: close the bridge with one forced jump
            # (consistent, higher variance on that last increment).
            q, log_w, log_z, n_resamples, ess, acc = self._bridge_step(
                q, log_w, log_z, n_resamples, key, max_steps + 1, beta, one,
                noise=step_noise(i))
            ess_buf[i] = ess
            acc_buf[i] = acc
            beta_buf[i] = one
            i += 1
        particles = self._finish(q, log_w, key, max_steps + 2, noise)
        return SMCResult(
            particles=particles, log_z=log_z, ess=ess_buf,
            n_resamples=n_resamples, acceptance_rate=acc_buf, n_steps=i,
            betas=beta_buf)
