"""Replica-exchange (parallel-tempering) HMC (port of
``zhusuan_tpu/mcmc/remc.py``).

The same posterior runs at a ladder of inverse temperatures ``beta_0 = 1 >
beta_1 > ... > beta_{K-1}``, and adjacent rungs swap configurations with
probability ``min(1, exp((beta_i - beta_j) (U_i - U_j)))``, ``U = -log
p``: hot replicas cross energy barriers and swaps carry what they find
down to the cold (target) rung (Swendsen & Wang 1986; Earl & Deem 2005).

The ladder is one more leading axis: the state is ``[n_temps, n_chains,
...]``; the momentum draw, the tempered leapfrog (the gradient of ``beta
log p`` is ``beta`` times the gradient) and the per-replica MH test are
the tensor math of :mod:`~zhusuan_tpu_torch.mcmc.base`; the per-rung step
sizes dual-average elementwise (an ``[n_temps]`` state); a swap round is
two masked pairwise exchanges (even pairs, then odd pairs on the next
round) from ``torch.roll`` + ``torch.where``. The base density at every
replica is carried across iterations, so swaps cost no density
evaluation. The tempered leapfrog has no hand-written kernel (nor a Pallas
one in the JAX package).

``key`` (a ``torch.Generator`` or a Philox key pair) gives iteration ``t``
the generator ``iteration_generator(key, t)`` on the chains' device: the
momenta (one normal per latent, sorted-name order), then the MH uniforms,
then the swap uniforms (each ``[n_temps, n_chains]``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import (
    dual_averaging_update,
    kinetic_energy,
    make_grad_fn,
    make_log_joint_fn,
    run_driver,
    tree_normal_like,
    tree_velocity,
)
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator

__all__ = ["ReplicaExchangeHMC", "REMCState", "REMCInfo"]

Latent = Dict[str, torch.Tensor]


class REMCState(NamedTuple):
    """q[name]: [n_temps, n_chains] + data_shape; per-rung tuner state;
    ``t`` a host int."""

    q: Latent
    t: int
    base_lp: torch.Tensor  # log p(q) at beta=1, [n_temps, n_chains]
    step_size: torch.Tensor  # [n_temps]
    da_step: torch.Tensor  # [n_temps]
    h_bar: torch.Tensor  # [n_temps]
    log_epsilon_bar: torch.Tensor  # [n_temps]


class REMCInfo(NamedTuple):
    samples: Latent  # the COLD rung's chains, [n_chains] + data_shape
    acceptance_rate: torch.Tensor  # [n_temps] mean MH acceptance per rung
    # [n_temps-1] swap acceptance per adjacent pair; NaN on rounds where
    # the pair was not attempted (even/odd alternation): aggregate with
    # nanmean.
    swap_rate: torch.Tensor
    step_size: torch.Tensor  # [n_temps]
    log_prob: torch.Tensor  # cold-rung log p, [n_chains]


def _rungs(v, leaf):
    """``[n_temps]`` values broadcast against a replica leaf."""
    return v.reshape((-1,) + (1,) * (leaf.ndim - 1))


class ReplicaExchangeHMC:
    """Parallel-tempering HMC over a geometric (or custom) beta ladder.

    :param betas: 1-D inverse temperatures, decreasing from ``1.0``
        (default: geometric ladder ``1.0 .. min_beta`` over ``n_temps``).
    :param n_temps, min_beta: ladder shape when ``betas`` is None.
    :param step_size: initial COLD-rung step size; rung k starts at
        ``step_size * beta_k**-0.5`` and each rung dual-averages
        independently to ``target_acceptance_rate``.
    :param n_leapfrogs: leapfrog steps (shared across rungs).
    :param swap_every: attempt swaps every this many iterations
        (alternating even / odd adjacent pairs).
    """

    def __init__(
        self,
        step_size: float = 0.1,
        n_leapfrogs: int = 10,
        betas=None,
        n_temps: int = 8,
        min_beta: float = 0.05,
        target_acceptance_rate: float = 0.8,
        swap_every: int = 1,
        gamma: float = 0.05,
        t0: float = 100.0,
        kappa: float = 0.75,
    ):
        if betas is None:
            betas = np.geomspace(1.0, float(min_beta), int(n_temps))
        betas = np.asarray(betas, np.float64)
        if betas.ndim != 1 or betas[0] != 1.0 or np.any(np.diff(betas) >= 0):
            raise ValueError(
                "betas must be 1-D, start at 1.0, and strictly decrease "
                "(got {}).".format(betas))
        self.betas = betas
        self.init_step_size = float(step_size)
        self.n_leapfrogs = int(n_leapfrogs)
        self.target_acceptance_rate = float(target_acceptance_rate)
        self.swap_every = int(swap_every)
        self.gamma = float(gamma)
        self.t0 = float(t0)
        self.kappa = float(kappa)
        self._beta_tensors = {}

    def _betas(self, dtype, device):
        """The ladder as a tensor, made once per dtype and device."""
        key = (dtype, str(device))
        if key not in self._beta_tensors:
            self._beta_tensors[key] = torch.tensor(self.betas, dtype=dtype,
                                                   device=device)
        return self._beta_tensors[key]

    # ------------------------------------------------------------------ #
    def init(self, latent: Latent, meta_bn, observed=None) -> REMCState:
        """``latent``: cold-chain initial positions ``[n_chains] + data``;
        every rung starts from a copy."""
        log_post = make_log_joint_fn(meta_bn, observed or {})
        n_temps = len(self.betas)
        q = {k: torch.as_tensor(v)[None].repeat(
                (n_temps,) + (1,) * torch.as_tensor(v).ndim)
             for k, v in latent.items()}
        leaf = next(iter(q.values()))
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for v in q.values()])
        betas = self._betas(dtype, leaf.device)
        zeros = torch.zeros(n_temps, dtype=dtype, device=leaf.device)
        with torch.no_grad():
            base_lp = log_post(q)
        return REMCState(
            q=q, t=0, base_lp=base_lp,
            step_size=(self.init_step_size / torch.sqrt(betas)).to(dtype),
            da_step=zeros, h_bar=zeros, log_epsilon_bar=zeros)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def sample(self, meta_bn, observed, state: REMCState, key=None,
               adapt=True, *, noise=None):
        """One iteration: per-rung HMC transition + (on schedule) one round
        of adjacent swaps.

        :param key: a ``torch.Generator`` or a Philox key ``(k0, k1)``.
        :param noise: testing hook in place of ``key``: ``(eps, u,
            u_swap)``, the momenta's standard normals (a dict like
            ``state.q``), the MH uniforms and the swap uniforms (each
            ``[n_temps, n_chains]``).
        """
        log_post = make_log_joint_fn(meta_bn, observed or {})
        grad_fn = make_grad_fn(log_post)
        q = state.q
        n_temps = len(self.betas)
        dtype = state.step_size.dtype
        device = state.step_size.device
        betas = self._betas(dtype, device)
        shape = tuple(state.base_lp.shape)
        if noise is not None:
            eps_in, u01, u_s = noise
            p = {n: torch.as_tensor(eps_in[n], dtype=q[n].dtype,
                                    device=device) for n in q}
            u01 = torch.as_tensor(u01, dtype=dtype, device=device)
            u_s = torch.as_tensor(u_s, dtype=dtype, device=device)
        else:
            gen = iteration_generator(as_key(key), state.t + 1, device)
            p = tree_normal_like(gen, q)
            u01 = torch.rand(shape, generator=gen, dtype=dtype,
                             device=device)
            u_s = torch.rand(shape, generator=gen, dtype=dtype,
                             device=device)

        # Tempered leapfrog: the gradient of beta * log p is beta * grad.
        eps = {n: _rungs(state.step_size, q[n]) for n in q}
        beta_t = {n: _rungs(betas, q[n]) for n in q}
        unit_mass = {n: torch.ones((), dtype=dtype, device=device)
                     for n in q}
        g = grad_fn(q)
        pp = {n: p[n] + 0.5 * eps[n] * beta_t[n] * g[n] for n in q}
        qq = dict(q)
        for i in range(self.n_leapfrogs):
            v = tree_velocity(pp, unit_mass)
            qq = {n: qq[n] + eps[n] * v[n] for n in qq}
            g = grad_fn(qq)
            scale = 1.0 if i < self.n_leapfrogs - 1 else 0.5
            pp = {n: pp[n] + scale * eps[n] * beta_t[n] * g[n] for n in qq}

        # Per-replica MH under the tempered density beta * log p.
        new_base_lp = log_post(qq)  # [K, C]
        old_h = -betas[:, None] * state.base_lp + kinetic_energy(
            q, p, unit_mass, 2)
        new_h = -betas[:, None] * new_base_lp + kinetic_energy(
            q, pp, unit_mass, 2)
        acc = torch.exp(torch.clamp(old_h - new_h, max=0.0))
        acc = torch.where(torch.isfinite(acc) & torch.isfinite(new_base_lp),
                          acc, torch.zeros_like(acc))
        take = u01 < acc  # [K, C]
        sel_q = {n: torch.where(take.reshape(take.shape + (1,) * (
            q[n].ndim - 2)), qq[n], q[n]) for n in q}
        base_lp = torch.where(take, new_base_lp, state.base_lp)

        # Adjacent swaps (even pairs on even rounds, odd on odd): swap
        # (i, i+1) w.p. min(1, exp(dbeta * (lp_{i+1} - lp_i))); no density
        # evaluation.
        do_swap = (state.t % self.swap_every) == 0
        parity = (state.t // self.swap_every) % 2
        idx = torch.arange(n_temps, device=device)
        pair_lead = ((idx % 2) == parity) & (idx + 1 < n_temps)
        lp_next = torch.roll(base_lp, -1, dims=0)
        dbeta = betas - torch.roll(betas, -1)  # beta_i - beta_{i+1}
        log_ratio = dbeta[:, None] * (base_lp - lp_next)
        swap_p = torch.exp(torch.clamp(-log_ratio, max=0.0))
        swap_lead = pair_lead[:, None] & (u_s < swap_p) & do_swap
        swap_follow = torch.roll(swap_lead, 1, dims=0)  # partner mask
        for n in q:
            x = sel_q[n]
            extra = (1,) * (x.ndim - 2)
            m_lead = swap_lead.reshape(swap_lead.shape + extra)
            m_follow = swap_follow.reshape(swap_follow.shape + extra)
            sel_q[n] = torch.where(m_lead, torch.roll(x, -1, dims=0),
                                   torch.where(m_follow,
                                               torch.roll(x, 1, dims=0), x))
        base_lp = torch.where(swap_lead, torch.roll(base_lp, -1, dims=0),
                              torch.where(swap_follow,
                                          torch.roll(base_lp, 1, dims=0),
                                          base_lp))

        # Per-rung dual averaging, elementwise over the [n_temps] state.
        mu = torch.log(10.0 * self.init_step_size / torch.sqrt(betas))
        mean_acc = torch.mean(acc, dim=1)
        step_size, da_step, h_bar, log_eps_bar = dual_averaging_update(
            state.da_step, state.h_bar, state.log_epsilon_bar,
            state.step_size, mean_acc, adapt,
            fresh_start=state.da_step == 0, mu=mu,
            target=self.target_acceptance_rate, gamma=self.gamma,
            t0=self.t0, kappa=self.kappa)
        step_size = step_size.to(dtype)
        new_state = REMCState(
            q=sel_q, t=state.t + 1, base_lp=base_lp, step_size=step_size,
            da_step=da_step, h_bar=h_bar, log_epsilon_bar=log_eps_bar)
        # Swap acceptance per adjacent pair; NaN where the pair was not
        # attempted this round.
        swap_rate = torch.where(
            pair_lead & do_swap,
            torch.sum(swap_lead.to(dtype), dim=1) / float(shape[1]),
            torch.full((n_temps,), math.nan, dtype=dtype, device=device))
        info = REMCInfo(
            samples={n: v[0] for n, v in sel_q.items()},
            acceptance_rate=mean_acc, swap_rate=swap_rate[:-1],
            step_size=step_size, log_prob=base_lp[0])
        return new_state, info

    # ------------------------------------------------------------------ #
    def run(self, meta_bn, observed, state: REMCState, key, n_iters: int,
            n_adapt: int = 0, collect: bool = True, *, noise=None):
        """``n_iters`` iterations in a Python loop over :meth:`sample`;
        step-size adaptation gated for the first ``n_adapt`` (by
        ``state.t``). Collected samples are the COLD rung's.

        :param noise: testing hook: a sequence of ``n_iters`` of
            :meth:`sample`'s ``noise`` tuples.
        """
        key = None if noise is not None else as_key(key)

        def one(st, i):
            return self.sample(meta_bn, observed, st, key,
                               adapt=n_adapt > 0 and st.t < n_adapt,
                               noise=None if noise is None else noise[i])

        def pick(info):
            return {"samples": info.samples,
                    "acceptance_rate": info.acceptance_rate,
                    "swap_rate": info.swap_rate,
                    "log_prob": info.log_prob}

        return run_driver(one, pick, state, n_iters, collect, 1)
