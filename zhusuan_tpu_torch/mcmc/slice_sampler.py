"""Coordinate-wise slice sampling (Neal 2003): stepping-out + shrinkage
(port of ``zhusuan_tpu/mcmc/slice_sampler.py``).

A gradient-free sampler with no rejections and no step-size cliff: the
interval adapts per draw. Explicit :class:`SliceState`, ``sample(state,
key) -> (state, info)``, ``run`` a Python loop over it; parallel chains
are leading axes.

- the latent dict is flattened to a ``[*, D]`` coordinate block (sorted
  names) and the sweep is a Python loop over its columns;
- stepping-out uses Neal's randomized budget split (``J ~ U{0..m-1}``
  expansions left, ``m-1-J`` right), reversible under the ``max_stepouts``
  cap; shrinkage is capped at ``max_shrinks``, and a chain that exhausts
  the cap keeps its coordinate (``SliceInfo.stuck_fraction``);
- both loops run over the whole batch of chains with per-chain active
  masks (a finished chain is frozen) and stop when no chain is active
  (one host read a trip) or at the cap, as
  :class:`~zhusuan_tpu_torch.mcmc.EllipticalSlice`'s shrink loop does;
- width self-tuning during burn-in reuses the EW moving-variance
  accumulator (:func:`~zhusuan_tpu_torch.mcmc.base.ewmv_update`) to set each
  coordinate's width to ``width_mult * std``.

Random numbers: ``key`` (a ``torch.Generator`` or a Philox key pair) gives
sweep ``t`` the generator ``iteration_generator(key, t)`` on the chains'
device, from which the whole sweep's numbers are drawn up front: the slice
heights' open-interval uniforms, the interval positions' uniforms, the
budget splits and the shrink uniforms, as :meth:`SliceSampler.sample`'s
``noise`` lays them out. A loop that ran every chain to its cap would use
the same numbers and give the same draws.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Union

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.utils import (
    open_interval_standard_uniform,
)
from zhusuan_tpu_torch.mcmc.base import ewmv_update, make_log_joint_fn, \
    run_driver
from zhusuan_tpu_torch.mcmc.rwm import CHECK, FILL, USE
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator

__all__ = ["SliceSampler", "SliceState", "SliceInfo"]

Latent = Dict[str, torch.Tensor]


class SliceState(NamedTuple):
    """Explicit slice-sampler state; ``t`` is a host int.

    Cache invariant (the ``MHState`` contract): ``log_prob`` is only valid
    for the target the state was last advanced under; ``init`` fills it
    with a NaN sentinel and ``sample`` re-evaluates whenever it is present.
    Call :meth:`invalidate_cache` after re-targeting a restored state.
    """

    q: Latent  # position: chain_axes + data_axes
    log_prob: torch.Tensor  # [chain_shape] cached log joint at q
    t: int
    width: torch.Tensor  # [D] per-coordinate interval widths
    ewmv_t: torch.Tensor  # EW variance accumulator (width adaptation)
    ewmv_mean: torch.Tensor  # [1, D]
    ewmv_var: torch.Tensor  # [1, D]

    def invalidate_cache(self) -> "SliceState":
        """Mark the density cache stale (NaN sentinel)."""
        return self._replace(log_prob=torch.full_like(self.log_prob,
                                                      float("nan")))


class SliceInfo(NamedTuple):
    """Per-iteration statistics."""

    samples: Latent
    log_prob: torch.Tensor  # [chain_shape] log joint at the new position
    width: torch.Tensor  # [D] (post-adaptation) widths
    stuck_fraction: torch.Tensor  # scalar: coordinate updates that
    #                               exhausted max_shrinks this sweep


def _flat_spec(q: Latent, n_chain_dims: int):
    """(names, data_shapes, sizes, D) of the sorted-name coordinate
    layout."""
    names = sorted(q.keys())
    data_shapes = [tuple(q[n].shape[n_chain_dims:]) for n in names]
    sizes = [math.prod(s) for s in data_shapes]
    return names, data_shapes, sizes, int(sum(sizes))


class SliceSampler:
    """Neal (2003) coordinate-wise slice sampler with stepping-out and
    shrinkage. Gradient-free; every chain moves every sweep.

    :param width: initial interval width: a positive float shared by all
        coordinates, or a dict mapping latent names to floats/arrays
        (broadcast over that latent's data axes).
    :param max_stepouts: total interval-expansion budget ``m`` per
        coordinate update, split randomly between the two ends.
    :param max_shrinks: shrinkage-loop bound; exhausted -> the coordinate
        keeps its current value (reported via ``stuck_fraction``).
    :param adapt_width: when True, ``sample(..., adapt=True)`` /
        ``run(..., n_adapt=k)`` self-tune per-coordinate widths to
        ``width_mult * std`` from an EW moving variance of the draws.
    :param width_decay: EW decay of the variance accumulator.
    :param width_mult: multiple of the posterior std used as the width.
    """

    def __init__(
        self,
        width: Union[float, Dict[str, torch.Tensor]] = 1.0,
        max_stepouts: int = 8,
        max_shrinks: int = 32,
        adapt_width: bool = False,
        width_decay: float = 0.99,
        width_mult: float = 2.0,
    ):
        if isinstance(width, dict):
            for name, v in width.items():
                if not np.all(np.asarray(v) > 0.0):
                    raise ValueError(
                        "width[{!r}] must be positive everywhere (a zero "
                        "width silently freezes that coordinate)."
                        .format(name))
        elif not float(width) > 0.0:
            raise ValueError("width must be positive.")
        self._width = width
        self._max_stepouts = int(max_stepouts)
        self._max_shrinks = int(max_shrinks)
        if self._max_stepouts < 1 or self._max_shrinks < 1:
            raise ValueError("max_stepouts/max_shrinks must be >= 1.")
        self._adapt = bool(adapt_width)
        self._decay = float(width_decay)
        self._mult = float(width_mult)

    # ------------------------------------------------------------------ #
    def init(self, latent: Latent, n_chain_dims: int) -> SliceState:
        """The initial state at positions of shape ``chain_axes +
        data_axes``; the density cache fills on the first ``sample``."""
        q = {k: torch.as_tensor(v) for k, v in latent.items()}
        if not isinstance(n_chain_dims, (int, np.integer)):
            raise TypeError("n_chain_dims must be a Python int.")
        n_chain_dims = int(n_chain_dims)
        names, data_shapes, sizes, total = _flat_spec(q, n_chain_dims)
        any_leaf = q[names[0]]
        chain_shape = any_leaf.shape[:n_chain_dims]
        for n in names:
            if q[n].shape[:n_chain_dims] != chain_shape:
                raise ValueError(
                    "All latents must share the chain shape; {!r} has {} "
                    "vs {}.".format(n, tuple(q[n].shape[:n_chain_dims]),
                                    tuple(chain_shape)))
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for v in q.values()])
        device = any_leaf.device
        if isinstance(self._width, dict):
            missing = set(names) - set(self._width)
            if missing:
                raise ValueError("width dict is missing latents: {}.".format(
                    sorted(missing)))
            width = torch.cat([
                torch.broadcast_to(torch.as_tensor(
                    self._width[n], dtype=dtype, device=device), shape)
                .reshape(size)
                for n, shape, size in zip(names, data_shapes, sizes)])
        else:
            width = torch.full((total,), float(self._width), dtype=dtype,
                               device=device)
        return SliceState(
            q=q,
            log_prob=torch.full(chain_shape, float("nan"), dtype=dtype,
                                device=device),
            t=0,
            width=width,
            ewmv_t=torch.zeros((), dtype=dtype, device=device),
            ewmv_mean=torch.zeros((1, total), dtype=dtype, device=device),
            ewmv_var=torch.ones((1, total), dtype=dtype, device=device))

    # ------------------------------------------------------------------ #
    @staticmethod
    def _any(flags) -> bool:
        """Whether a loop goes on: any chain still active (a host read)."""
        return bool(flags.any())

    def _draw(self, gen, chain_shape, total, dtype, device):
        """A sweep's random numbers (``sample``'s ``noise`` layout)."""
        shape = (total,) + tuple(chain_shape)
        u_y = open_interval_standard_uniform(gen, shape, dtype, device)
        u_pos = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        budget = torch.randint(0, self._max_stepouts, shape, generator=gen,
                               device=device)
        shrink = torch.rand((total, self._max_shrinks) + tuple(chain_shape),
                            generator=gen, dtype=dtype, device=device)
        return u_y, u_pos, budget, shrink

    def sample(self, meta_bn, observed, state: SliceState, key=None,
               adapt=None, *, noise=None):
        """One full coordinate sweep over all chains.

        :param key: a ``torch.Generator`` or a Philox key ``(k0, k1)``.
        :param adapt: bool gating width adaptation (defaults to the
            constructor's ``adapt_width``).
        :param noise: testing hook in place of ``key``: ``(u_y, u_pos,
            budget, shrink)``, per coordinate ``j`` (sorted-name order) the
            slice height's open-interval uniforms ``u_y[j]``, the interval
            position's uniforms ``u_pos[j]``, the left expansion budgets
            ``budget[j]`` in ``{0..max_stepouts-1}`` (each chain-shaped),
            and ``shrink[j]`` of shape ``[max_shrinks, *chain_shape]``, the
            ``i``-th shrink's uniforms.
        :return: ``(new_state, SliceInfo)``.
        """
        return self._transition(meta_bn, observed, state, key, adapt, noise,
                                 CHECK)

    def _transition(self, meta_bn, observed, state, key, adapt, noise,
                    cache):
        log_posterior = make_log_joint_fn(meta_bn, observed)
        q = state.q
        chain_shape = tuple(state.log_prob.shape)
        chain_ndim = len(chain_shape)
        names, data_shapes, sizes, total = _flat_spec(q, chain_ndim)
        dtype, device = state.width.dtype, state.width.device

        def unflatten(flat):
            out, off = {}, 0
            for n, shape, s in zip(names, data_shapes, sizes):
                out[n] = flat[..., off:off + s].reshape(
                    chain_shape + shape).to(q[n].dtype)
                off += s
            return out

        def lp_at(flat, col, value):
            """The density with column ``col`` (a one-hot mask) set to
            ``value``."""
            return log_posterior(unflatten(
                torch.where(col, value[..., None], flat))).to(dtype)

        with torch.no_grad():
            flat = torch.cat([q[n].to(dtype).reshape(chain_shape + (s,))
                              for n, s in zip(names, sizes)], dim=-1)
            lp = state.log_prob
            if cache == FILL or (cache == CHECK
                                 and bool(torch.isnan(lp).any())):
                lp = log_posterior(q)
            lp = lp.to(dtype)
            if noise is None:
                noise = self._draw(
                    iteration_generator(as_key(key), state.t + 1, device),
                    chain_shape, total, dtype, device)
            u_y, u_pos, budget, shrink = (torch.as_tensor(v, device=device)
                                          for v in noise)
            m, n_shrinks = self._max_stepouts, self._max_shrinks
            cols = torch.eye(total, dtype=torch.bool, device=device)
            stuck = []
            for j in range(total):
                col = cols[j]
                w = state.width[j]
                x0 = flat[..., j]
                # Slice height y = lp + log U (Neal 2003 eq. 7).
                y = lp + torch.log(u_y[j].to(dtype))
                left = x0 - u_pos[j].to(dtype) * w
                right = left + w
                jb = budget[j].to(torch.int64)
                kb = (m - 1) - jb
                go_l = (lp_at(flat, col, left) > y) & (jb > 0)
                go_r = (lp_at(flat, col, right) > y) & (kb > 0)
                # Stepping out: a chain stops expanding an end for good.
                for _ in range(m - 1):
                    if not self._any(go_l | go_r):
                        break
                    left = torch.where(go_l, left - w, left)
                    right = torch.where(go_r, right + w, right)
                    jb = jb - go_l.to(jb.dtype)
                    kb = kb - go_r.to(kb.dtype)
                    go_l = go_l & (lp_at(flat, col, left) > y) & (jb > 0)
                    go_r = go_r & (lp_at(flat, col, right) > y) & (kb > 0)
                # Shrinkage: draw on (L, R); accept above the slice, else
                # shrink the violated end toward x0 (Neal 2003 Fig. 5).
                x, lp_x = x0, lp
                accepted = torch.zeros(chain_shape, dtype=torch.bool,
                                       device=device)
                for i in range(n_shrinks):
                    if i > 0 and not self._any(~accepted):
                        break
                    cand = left + shrink[j][i].to(dtype) * (right - left)
                    lp_c = lp_at(flat, col, cand)
                    ok = lp_c > y
                    newly = ok & ~accepted
                    x = torch.where(newly, cand, x)
                    lp_x = torch.where(newly, lp_c, lp_x)
                    bad = ~(ok | accepted)
                    left = torch.where(bad & (cand < x0), cand, left)
                    right = torch.where(bad & (cand >= x0), cand, right)
                    accepted = accepted | ok
                flat = torch.where(col, x[..., None], flat)
                lp = lp_x
                stuck.append(torch.mean((~accepted).to(dtype)))
            q1 = unflatten(flat)

            gate = self._adapt if adapt is None else adapt
            ewmv_t, ewmv_mean, ewmv_var = ewmv_update(
                {"x": flat.reshape(-1, total)}, state.ewmv_t,
                {"x": state.ewmv_mean}, {"x": state.ewmv_var}, gate,
                n_chain_dims=1, decay=self._decay)
            width = state.width
            if gate:
                width = (self._mult * torch.sqrt(torch.clamp(
                    ewmv_var["x"][0], min=1e-20))).to(dtype)
        new_state = SliceState(
            q=q1, log_prob=lp, t=state.t + 1, width=width,
            ewmv_t=ewmv_t.to(dtype), ewmv_mean=ewmv_mean["x"].to(dtype),
            ewmv_var=ewmv_var["x"].to(dtype))
        info = SliceInfo(
            samples=q1, log_prob=lp, width=width,
            stuck_fraction=torch.mean(torch.stack(stuck)) if stuck
            else torch.zeros((), dtype=dtype, device=device))
        return new_state, info

    # ------------------------------------------------------------------ #
    _VALID_FIELDS = ("samples", "log_prob", "width", "stuck_fraction")

    def run(
        self,
        meta_bn,
        observed,
        state: SliceState,
        key,
        n_iters: int,
        n_adapt: int = 0,
        collect: bool = True,
        collect_fields=("samples", "log_prob"),
        thinning: int = 1,
        *,
        noise=None,
    ):
        """``n_iters`` sweeps in a Python loop over :meth:`sample`. Width
        adaptation is gated on the PERSISTED counter ``state.t < n_adapt``
        (the ``HMC.run`` convention).

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
            return self._transition(
                meta_bn, observed, st, key, adapt_on and st.t < n_adapt,
                None if noise is None else noise[i], CHECK if i == 0 else USE)

        def pick(info):
            full = {"samples": info.samples, "log_prob": info.log_prob,
                    "width": info.width,
                    "stuck_fraction": info.stuck_fraction}
            return {f: full[f] for f in collect_fields}

        return run_driver(one, pick, state, n_iters, collect, thinning)
