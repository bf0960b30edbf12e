"""Random-walk Metropolis and MALA: gradient-free and first-order baseline
samplers (port of ``zhusuan_tpu/mcmc/rwm.py``).

RWM (gradient-free: works on log-joints with non-differentiable pieces)
and MALA (one gradient per step) complete the sampler matrix next to HMC.
Explicit :class:`MHState`, ``sample(state, key) -> (state, info)``, and
``run`` a Python loop over it; parallel chains are leading axes. Step sizes
adapt by the shared Nesterov dual averaging
(:func:`~zhusuan_tpu_torch.mcmc.base.dual_averaging_update`) toward 0.234
(RWM, Roberts et al. 1997) or 0.574 (MALA, Roberts & Rosenthal 1998). The
log-density (and score, for MALA) at the current point is carried in the
state, so an iteration costs ONE density (+ gradient) evaluation: the
proposal's.

``state.t`` is a host int. ``key`` is a ``torch.Generator`` or a Philox
key pair (as :class:`~zhusuan_tpu_torch.mcmc.HMC` takes): iteration ``t``
draws from ``iteration_generator(key, t)`` on the chains' device, the
proposal normals first (one per latent, sorted-name order), then the MH
uniform. ``noise=(xi, u)`` replaces them. The cache's NaN sentinel is
tested on the host by :meth:`_MetropolisBase.sample` (one read);
:meth:`~_MetropolisBase.run` tests it once, since a live cache is never NaN
(a proposal with a non-finite density is rejected), and
:class:`~zhusuan_tpu_torch.mcmc.Gibbs` refills it unread.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import (
    dual_averaging_update,
    make_log_joint_fn,
    run_driver,
    tree_normal_like,
)
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator

__all__ = ["RandomWalkMetropolis", "MALA", "MHState", "MHInfo"]

Latent = Dict[str, torch.Tensor]

# How a transition treats the density cache: test the NaN sentinel on the
# host ("check"), re-evaluate unread ("fill"), or trust it ("use").
CHECK, FILL, USE = "check", "fill", "use"


class MHState(NamedTuple):
    """Explicit Metropolis sampler state; ``t`` is a host int.

    Cache invariant: ``log_prob`` / ``grad`` are only valid for the target
    the state was last advanced under. ``init`` fills them with a NaN
    sentinel and ``sample`` re-evaluates whenever it is present; call
    :meth:`invalidate_cache` after re-targeting a restored state.
    """

    q: Latent  # position: chain_axes + data_axes
    log_prob: torch.Tensor  # [chain_shape] cached log joint at q
    grad: Latent  # cached score at q (MALA; an EMPTY dict for RWM)
    t: int
    step_size: torch.Tensor  # scalar
    da_step: torch.Tensor
    h_bar: torch.Tensor
    log_epsilon_bar: torch.Tensor

    def invalidate_cache(self) -> "MHState":
        """Mark the density/score cache stale (NaN sentinel)."""
        return self._replace(log_prob=torch.full_like(self.log_prob,
                                                      float("nan")))


class MHInfo(NamedTuple):
    """Per-iteration statistics."""

    samples: Latent
    acceptance_rate: torch.Tensor  # [chain_shape] min(1, exp(log_alpha))
    updated_step_size: torch.Tensor
    log_prob: torch.Tensor  # [chain_shape] log joint at the new position


def _pick(accept, new, old):
    mask = accept.reshape(accept.shape + (1,) * (new.ndim - accept.ndim))
    return torch.where(mask, new, old)


class _MetropolisBase:
    """Shared init / adaptation / run driver for RWM and MALA."""

    _uses_grad = False
    _default_target = 0.234

    def __init__(
        self,
        step_size: float = 0.1,
        adapt_step_size: bool = False,
        target_acceptance_rate: Optional[float] = None,
        gamma: float = 0.05,
        t0: float = 100.0,
        kappa: float = 0.75,
    ):
        if not float(step_size) > 0.0:
            raise ValueError("step_size must be positive.")
        self._step_size = float(step_size)
        self._adapt = bool(adapt_step_size)
        self._target = float(self._default_target
                             if target_acceptance_rate is None
                             else target_acceptance_rate)
        if not 0.0 < self._target < 1.0:
            raise ValueError("target_acceptance_rate must be in (0, 1).")
        self._gamma, self._t0, self._kappa = gamma, t0, kappa

    def init(self, latent: Latent, n_chain_dims: int) -> MHState:
        """The initial state at positions of shape ``chain_axes +
        data_axes`` (``HMC.init``'s convention); the density/score cache
        fills on the first ``sample``."""
        q = {k: torch.as_tensor(v) for k, v in latent.items()}
        if not isinstance(n_chain_dims, (int, np.integer)):
            raise TypeError("n_chain_dims must be a Python int.")
        any_leaf = next(iter(q.values()))
        chain_shape = any_leaf.shape[: int(n_chain_dims)]
        zero = torch.zeros((), dtype=any_leaf.dtype, device=any_leaf.device)
        return MHState(
            q=q,
            log_prob=torch.full(chain_shape, float("nan"),
                                dtype=any_leaf.dtype, device=any_leaf.device),
            grad={k: torch.zeros_like(v) for k, v in q.items()}
            if self._uses_grad else {},
            t=0,
            step_size=torch.full((), self._step_size, dtype=any_leaf.dtype,
                                 device=any_leaf.device),
            da_step=zero, h_bar=zero, log_epsilon_bar=zero)

    # subclasses: _propose(log_posterior, state, xi) ->
    #   (q_new, lp_new, grad_new, log_alpha)
    def _propose(self, log_posterior, state, xi):
        raise NotImplementedError()

    def _eval(self, log_posterior, q):
        """(log_prob, score): the score only when the kernel needs it, by
        autograd of the summed log joint (each chain's in its slot)."""
        if self._uses_grad:
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in q.items()}
                lp = log_posterior(leaves)
                grads = torch.autograd.grad(torch.sum(lp),
                                            list(leaves.values()),
                                            allow_unused=True)
            return lp.detach(), {
                k: (g if g is not None else torch.zeros_like(leaves[k]))
                for k, g in zip(leaves, grads)}
        with torch.no_grad():
            return log_posterior(q), {}

    def sample(self, meta_bn, observed, state: MHState, key=None,
               adapt=None, *, noise=None):
        """One Metropolis step over all chains.

        :param key: a ``torch.Generator`` or a Philox key ``(k0, k1)``; see
            the module docstring.
        :param adapt: bool gating step-size adaptation (defaults to the
            constructor's ``adapt_step_size``).
        :param noise: testing hook in place of ``key``: ``(xi, u)``, the
            proposal's standard normals (a dict like ``state.q``) and the
            chain-shaped MH uniforms.
        :return: ``(new_state, MHInfo)``.
        """
        return self._transition(meta_bn, observed, state, key, adapt, noise,
                                CHECK)

    def _transition(self, meta_bn, observed, state, key, adapt, noise,
                    cache):
        log_posterior = make_log_joint_fn(meta_bn, observed)
        lp0, g0 = state.log_prob, state.grad
        if cache == FILL or (cache == CHECK
                             and bool(torch.isnan(lp0).any())):
            lp0, g0 = self._eval(log_posterior, state.q)
        state = state._replace(log_prob=lp0, grad=g0)
        if noise is not None:
            xi, u = noise
            xi = {k: torch.tensor(xi[k], dtype=v.dtype, device=v.device)
                  for k, v in state.q.items()}
            u = torch.as_tensor(u, dtype=lp0.dtype, device=lp0.device)
        else:
            gen = iteration_generator(as_key(key), state.t + 1, lp0.device)
            xi, u = tree_normal_like(gen, state.q), None
        q_new, lp_new, g_new, log_alpha = self._propose(log_posterior, state,
                                                        xi)
        with torch.no_grad():
            # Reject a bad PROPOSAL (non-finite density, or NaN anywhere in
            # the ratio); log_alpha = +inf stays an accept: a chain leaving
            # a zero-density point.
            bad = torch.isnan(log_alpha) | ~torch.isfinite(lp_new)
            log_alpha = torch.where(bad, -math.inf, log_alpha)
            accept_rate = torch.clamp(
                torch.exp(torch.clamp(log_alpha, max=0.0)), max=1.0)
            if u is None:
                u = torch.rand(log_alpha.shape, generator=gen,
                               dtype=log_alpha.dtype, device=log_alpha.device)
            accept = torch.log(u) < log_alpha
            q = {k: _pick(accept, q_new[k], state.q[k]) for k in state.q}
            lp = torch.where(accept, lp_new, state.log_prob)
            g = {k: _pick(accept, g_new[k], state.grad[k])
                 for k in state.grad}
            gate = self._adapt if adapt is None else adapt
            step_size, da_step, h_bar, log_eps_bar = dual_averaging_update(
                state.da_step, state.h_bar, state.log_epsilon_bar,
                state.step_size, torch.mean(accept_rate), gate,
                fresh_start=state.t == 0,
                mu=float(np.log(10.0 * self._step_size)),
                target=self._target, gamma=self._gamma, t0=self._t0,
                kappa=self._kappa)
        ss_dtype = state.step_size.dtype
        new_state = MHState(
            q=q, log_prob=lp, grad=g, t=state.t + 1,
            step_size=step_size.to(ss_dtype), da_step=da_step.to(ss_dtype),
            h_bar=h_bar.to(ss_dtype), log_epsilon_bar=log_eps_bar.to(ss_dtype))
        return new_state, MHInfo(samples=q, acceptance_rate=accept_rate,
                                 updated_step_size=new_state.step_size,
                                 log_prob=lp)

    _VALID_FIELDS = ("samples", "acceptance_rate", "step_size", "log_prob")

    def run(
        self,
        meta_bn,
        observed,
        state: MHState,
        key,
        n_iters: int,
        n_adapt: int = 0,
        collect: bool = True,
        collect_fields=("samples", "acceptance_rate", "step_size",
                        "log_prob"),
        thinning: int = 1,
        *,
        noise=None,
    ):
        """``n_iters`` iterations in a Python loop over :meth:`sample`.

        Adaptation is gated on the PERSISTED counter ``state.t < n_adapt``
        (``HMC.run``'s convention): a resumed state whose ``t`` already
        passed ``n_adapt`` does not re-adapt.

        :param collect_fields: which outputs to stack.
        :param thinning: stack every ``thinning``-th iteration only; the
            draws are the unthinned run's (they depend on the key and
            ``state.t``), so the output IS the full trajectory sliced
            ``thinning-1::thinning``.
        :param noise: testing hook: a sequence of ``n_iters`` of
            :meth:`sample`'s ``noise`` tuples.
        :return: ``(final_state, {field: stacked} or None)``.
        """
        for f in collect_fields:
            if f not in self._VALID_FIELDS:
                raise ValueError("Unknown collect field {!r}; valid: {}."
                                 .format(f, self._VALID_FIELDS))
        key = None if noise is not None else as_key(key)
        adapt_on = self._adapt and n_adapt > 0

        def one(st, i):
            gate = adapt_on and st.t < n_adapt
            return self._transition(meta_bn, observed, st, key, gate,
                                    None if noise is None else noise[i],
                                    CHECK if i == 0 else USE)

        def pick(info):
            full = {"samples": info.samples,
                    "acceptance_rate": info.acceptance_rate,
                    "step_size": info.updated_step_size,
                    "log_prob": info.log_prob}
            return {f: full[f] for f in collect_fields}

        return run_driver(one, pick, state, n_iters, collect, thinning)


class RandomWalkMetropolis(_MetropolisBase):
    """Gaussian random-walk Metropolis: ``q' = q + eps * xi``.

    Gradient-free. Adaptation targets the 0.234 optimal acceptance rate
    (Roberts, Gelman & Gilks 1997).
    """

    _uses_grad = False
    _default_target = 0.234

    def _propose(self, log_posterior, state, xi):
        eps = state.step_size
        q_new = {k: state.q[k] + eps * xi[k] for k in state.q}
        with torch.no_grad():
            lp_new = log_posterior(q_new)
        # Symmetric proposal: alpha = p(q')/p(q).
        return q_new, lp_new, {}, lp_new - state.log_prob


class MALA(_MetropolisBase):
    """Metropolis-adjusted Langevin: ``q' = q + (eps^2/2) grad log p(q) +
    eps * xi`` with the asymmetric Hastings correction; one density and
    gradient evaluation per iteration (the score at the current position
    is carried in the state). Adaptation targets 0.574 (Roberts & Rosenthal
    1998).
    """

    _uses_grad = True
    _default_target = 0.574

    @staticmethod
    def _log_q(q_to, q_from, g_from, eps, chain_ndim):
        """log density of proposing ``q_to`` from ``q_from`` (up to the
        shared normal constant), summed over data axes of every latent."""
        total = None
        for name in sorted(q_to.keys()):
            mean = q_from[name] + 0.5 * eps * eps * g_from[name]
            diff = q_to[name] - mean
            axes = tuple(range(chain_ndim, diff.ndim))
            sq = torch.sum(diff * diff, dim=axes) if axes else diff * diff
            term = -sq / (2.0 * eps * eps)
            total = term if total is None else total + term
        return total

    def _propose(self, log_posterior, state, xi):
        eps = state.step_size
        chain_ndim = state.log_prob.ndim
        q_new = {k: state.q[k] + 0.5 * eps * eps * state.grad[k]
                 + eps * xi[k] for k in state.q}
        lp_new, g_new = self._eval(log_posterior, q_new)
        log_alpha = (
            lp_new - state.log_prob
            + self._log_q(state.q, q_new, g_new, eps, chain_ndim)
            - self._log_q(q_new, state.q, state.grad, eps, chain_ndim))
        return q_new, lp_new, g_new, log_alpha
