"""Exact-conditional Gibbs sampling for finite-support discrete latents
(port of ``zhusuan_tpu/mcmc/discrete.py``).

:class:`DiscreteGibbs` draws each discrete coordinate from its EXACT full
conditional: enumerate the K support values, score the joint at each, one
categorical draw. Rejection-free and tuning-free; compose it with
:class:`~zhusuan_tpu_torch.mcmc.Gibbs` to alternate with HMC/NUTS on a
continuous block.

A sweep is a Python loop over each latent's coordinates (sorted names);
a coordinate's K candidates are scored by ONE batched density call
(``torch.func.vmap`` over the support, as the JAX package ``vmap``s it),
giving a ``[K, *chain_shape]`` score tensor, and the categorical draw is
the arg-max of the scores plus Gumbel noise (``jax.random.categorical``'s
own method). ``key`` (a ``torch.Generator`` or a Philox key pair) gives
sweep ``t`` the generator ``iteration_generator(key, t)`` on the chains'
device, from which each latent's Gumbels are drawn in one call.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.utils import (
    open_interval_standard_uniform,
)
from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn, run_driver
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator

__all__ = ["DiscreteGibbs", "DiscreteGibbsState", "DiscreteGibbsInfo"]

Latent = Dict[str, torch.Tensor]


class DiscreteGibbsState(NamedTuple):
    """Explicit sampler state (position + sweep counter, a host int; exact
    conditionals need no tuning state and no density cache)."""

    q: Latent  # position: chain_axes + data_axes
    t: int

    def invalidate_cache(self) -> "DiscreteGibbsState":
        """No-op (kept for the Gibbs component contract: there is no
        cached density to go stale)."""
        return self


class DiscreteGibbsInfo(NamedTuple):
    """Per-sweep statistics."""

    samples: Latent
    log_prob: torch.Tensor  # [chain_shape] log joint after the sweep


class DiscreteGibbs:
    """Systematic-scan exact Gibbs over finite-support discrete latents.

    :param support: dict mapping each owned latent name to a 1-D array of
        its support values (shared by every coordinate of that latent),
        e.g. ``{"labels": torch.arange(K, dtype=torch.float32)}``. Values
        are cast to the latent's dtype and device at sample time.
    """

    def __init__(self, support: Dict[str, torch.Tensor]):
        if not support:
            raise ValueError("support must name at least one latent.")
        self._support = {}
        for name, vals in support.items():
            vals = torch.as_tensor(vals)
            if vals.ndim != 1 or vals.shape[0] < 2:
                raise ValueError(
                    "support[{!r}] must be a 1-D array of >= 2 values; got "
                    "shape {}.".format(name, tuple(vals.shape)))
            self._support[name] = vals

    # ------------------------------------------------------------------ #
    def init(self, latent: Latent, n_chain_dims: int) -> DiscreteGibbsState:
        """The initial state at positions of shape ``chain_axes +
        data_axes`` (the ``HMC.init`` convention)."""
        q = {k: torch.as_tensor(v) for k, v in latent.items()}
        if not isinstance(n_chain_dims, (int, np.integer)):
            raise TypeError("n_chain_dims must be a Python int.")
        missing = set(q) - set(self._support)
        extra = set(self._support) - set(q)
        if missing or extra:
            raise ValueError(
                "support must exactly cover the latent dict; missing "
                "support for {}, unused support {}.".format(
                    sorted(missing), sorted(extra)))
        return DiscreteGibbsState(q=q, t=0)

    # ------------------------------------------------------------------ #
    def sample(self, meta_bn, observed, state: DiscreteGibbsState, key=None,
               adapt=None, *, noise=None):
        """One systematic sweep: every coordinate of every owned latent
        redrawn from its exact full conditional. ``adapt`` is accepted and
        ignored (the Gibbs component contract).

        :param key: a ``torch.Generator`` or a Philox key ``(k0, k1)``.
        :param noise: testing hook in place of ``key``: ``{name:
            [n_coords, K, *chain_shape]}``, the Gumbel draws behind each
            coordinate's categorical draw (``n_coords`` the latent's data
            size, ``K`` its support size).
        :return: ``(new_state, DiscreteGibbsInfo)``.
        """
        log_posterior = make_log_joint_fn(meta_bn, observed)
        q = dict(state.q)
        with torch.no_grad():
            chain_shape = tuple(log_posterior(q).shape)
        gen = None
        if noise is None:
            gen = iteration_generator(as_key(key), state.t + 1,
                                      next(iter(q.values())).device)
        lp_last = None
        for name in sorted(q):
            arr = q[name]
            support = self._support[name].to(dtype=arr.dtype,
                                              device=arr.device)
            n_coords = math.prod(arr.shape[len(chain_shape):])
            flat = arr.reshape(chain_shape + (n_coords,))
            shape = (n_coords, support.shape[0]) + chain_shape
            if noise is not None:
                gumbel = torch.as_tensor(noise[name], device=arr.device)
            else:
                u = open_interval_standard_uniform(gen, shape, arr.dtype,
                                                   arr.device)
                gumbel = -torch.log(-torch.log(u))
            cols = torch.eye(n_coords, dtype=torch.bool, device=arr.device)
            for j in range(n_coords):
                col = cols[j]

                def lp_at(v, flat=flat, col=col):
                    qq = dict(q)
                    qq[name] = torch.where(col, v, flat).reshape(arr.shape)
                    return log_posterior(qq)

                with torch.no_grad():
                    # [K, chain_shape] conditional scores at each value.
                    scores = torch.func.vmap(lp_at)(support)
                idx = torch.argmax(scores + gumbel[j].to(scores.dtype), dim=0)
                flat = torch.where(col, support[idx][..., None], flat)
                lp_last = torch.take_along_dim(scores, idx[None], dim=0)[0]
            q[name] = flat.reshape(arr.shape)
        new_state = DiscreteGibbsState(q=q, t=state.t + 1)
        return new_state, DiscreteGibbsInfo(samples=q, log_prob=lp_last)

    # ------------------------------------------------------------------ #
    _VALID_FIELDS = ("samples", "log_prob")

    def run(
        self,
        meta_bn,
        observed,
        state: DiscreteGibbsState,
        key,
        n_iters: int,
        n_adapt: int = 0,
        collect: bool = True,
        collect_fields=("samples", "log_prob"),
        thinning: int = 1,
        *,
        noise=None,
    ):
        """``n_iters`` sweeps in a Python loop over :meth:`sample`
        (``n_adapt`` is accepted for interface uniformity and ignored).

        :param noise: testing hook: a sequence of ``n_iters`` of
            :meth:`sample`'s ``noise`` dicts.
        :return: ``(final_state, {field: stacked} or None)``.
        """
        for f in collect_fields:
            if f not in self._VALID_FIELDS:
                raise ValueError("Unknown collect field {!r}; valid: {}."
                                 .format(f, self._VALID_FIELDS))
        key = None if noise is not None else as_key(key)

        def one(st, i):
            return self.sample(meta_bn, observed, st, key,
                               noise=None if noise is None else noise[i])

        def pick(info):
            full = {"samples": info.samples, "log_prob": info.log_prob}
            return {f: full[f] for f in collect_fields}

        return run_driver(one, pick, state, n_iters, collect, thinning)
