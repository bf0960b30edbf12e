"""Elliptical slice sampling (Murray, Adams & MacKay 2010; port of
``zhusuan_tpu/mcmc/elliptical.py``).

ESS samples ``p(f) ∝ N(f; 0, Sigma) L(f)`` with no tuning parameter and
no rejection: propose on the ellipse through the current state and a prior
draw, shrink the angle bracket until the likelihood threshold is met.

Chains are leading axes. The per-chain shrink loop is one Python loop over
the whole batch with a per-chain accepted mask (accepted chains freeze
while the rest shrink); it stops when every chain has accepted or after
``max_shrink`` shrinks (a chain still rejected then stays where it was:
the ``theta -> 0`` limit). Its test reads one flag to the host a shrink;
the likelihood cache's NaN test reads one more an iteration. JAX's
``lax.cond`` and ``lax.while_loop`` become these host tests.

The target splits into its Gaussian prior (per-name scales or Cholesky
factors, given to the constructor) and the likelihood ``log L(f)`` (a
``MetaBayesianNet`` or callable, given to ``sample`` / ``run``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn, tree_normal_like

__all__ = ["EllipticalSlice", "EllipticalSliceState", "EllipticalSliceInfo",
           "state_from_numpy", "state_to_numpy"]

Latent = Dict[str, torch.Tensor]


class EllipticalSliceState(NamedTuple):
    """Explicit sampler state; ``t`` is a host int.

    ``log_lik`` caches the likelihood at ``f`` for the target the state
    was last advanced under. ``init`` fills it with NaN and ``sample``
    re-evaluates on NaN; call :meth:`invalidate_cache` after re-targeting
    a restored state.
    """

    f: Latent  # positions: chain axes + data axes
    log_lik: torch.Tensor  # [chain_shape] cached log likelihood at f
    t: int

    def invalidate_cache(self) -> "EllipticalSliceState":
        """Mark the cache stale; the next ``sample`` re-evaluates it."""
        return self._replace(log_lik=torch.full_like(self.log_lik,
                                                     float("nan")))


class EllipticalSliceInfo(NamedTuple):
    """Per-iteration statistics."""

    samples: Latent
    log_lik: torch.Tensor  # [chain_shape]
    n_shrinks: int  # trips of the shrink loop this iteration


class EllipticalSlice:
    """Elliptical slice sampler for latents with centred Gaussian priors.

    :param prior_std: a scalar, or a per-name dict of scalars or tensors:
        the prior ``N(0, diag(prior_std^2))`` of each latent (broadcast
        over its data axes); unused for names in ``prior_chol``.
    :param prior_chol: optional per-name ``[d, d]`` lower Cholesky factor
        of the prior covariance on the last data axis (the GP case:
        ``chol(K)``).
    :param max_shrink: bound on the shrinks of one iteration.
    """

    def __init__(self, prior_std: Union[float, Dict] = 1.0,
                 prior_chol: Optional[Dict] = None, max_shrink: int = 64):
        self._prior_std = prior_std
        self._prior_chol = dict(prior_chol or {})
        if int(max_shrink) < 1:
            raise ValueError("max_shrink must be >= 1.")
        self._max_shrink = int(max_shrink)

    def _std_for(self, name):
        if isinstance(self._prior_std, dict):
            if name not in self._prior_std:
                raise KeyError(
                    "No prior_std entry (and no prior_chol) for latent "
                    "{!r}.".format(name))
            return self._prior_std[name]
        return self._prior_std

    def _prior_draw(self, unit: Latent) -> Latent:
        """Prior draws from unit normals ``unit``."""
        out = {}
        for name, eps in unit.items():
            if name in self._prior_chol:
                chol = torch.as_tensor(self._prior_chol[name],
                                       dtype=eps.dtype, device=eps.device)
                out[name] = torch.einsum("ij,...j->...i", chol, eps)
            else:
                out[name] = eps * torch.as_tensor(
                    self._std_for(name), dtype=eps.dtype, device=eps.device)
        return out

    def init(self, latent: Latent, n_chain_dims: int) -> EllipticalSliceState:
        """The initial state at positions of shape ``chain_axes +
        data_axes`` (``HMC.init``'s convention); the likelihood cache
        fills on the first ``sample``."""
        f = {k: torch.as_tensor(v) for k, v in latent.items()}
        if not isinstance(n_chain_dims, (int, np.integer)):
            raise TypeError("n_chain_dims must be a Python int.")
        any_leaf = next(iter(f.values()))
        chain_shape = any_leaf.shape[:int(n_chain_dims)]
        for name in f:
            if name not in self._prior_chol:
                self._std_for(name)  # check coverage now
        return EllipticalSliceState(
            f=f,
            log_lik=torch.full(chain_shape, float("nan"),
                               dtype=any_leaf.dtype, device=any_leaf.device),
            t=0)

    def sample(self, meta_bn, observed, state: EllipticalSliceState,
               generator=None, *, noise=None):
        """One ESS transition of every chain. ``meta_bn`` is the likelihood
        factor ``log L(f)`` alone (the prior lives in the constructor).

        :param generator: a ``torch.Generator`` on the chains' device.
        :param noise: testing hook in place of ``generator``: ``(nu, u,
            theta, shrink_u)``, the unit normals of the prior draw (a dict
            like ``state.f``), the slice uniforms and the initial angles in
            ``[0, 2 pi)`` (chain-shaped), and ``[max_shrink, *chain_shape]``
            uniforms, the ``i``-th for the ``i``-th shrink.
        :return: ``(new_state, EllipticalSliceInfo)``.
        """
        log_lik_fn = make_log_joint_fn(meta_bn, observed)
        f = state.f
        with torch.no_grad():
            ll0 = state.log_lik
            if bool(torch.isnan(ll0).any()):
                ll0 = log_lik_fn(f)
            chain_shape = ll0.shape
            dtype, device = ll0.dtype, ll0.device
            two_pi = 2.0 * math.pi
            if noise is not None:
                nu_eps, u, theta, shrink_u = noise
                nu = self._prior_draw({
                    k: torch.as_tensor(nu_eps[k], dtype=v.dtype,
                                       device=v.device)
                    for k, v in f.items()})
                u = torch.as_tensor(u, dtype=dtype, device=device)
                theta = torch.as_tensor(theta, dtype=dtype, device=device)
                shrink_u = torch.as_tensor(shrink_u, dtype=dtype,
                                           device=device)
            else:
                if generator is None:
                    raise ValueError("sample needs a torch.Generator or "
                                     "noise.")
                nu = self._prior_draw(tree_normal_like(generator, f))
                u = torch.rand(chain_shape, generator=generator,
                               dtype=dtype, device=device)
                theta = two_pi * torch.rand(chain_shape, generator=generator,
                                            dtype=dtype, device=device)
            # Slice threshold: log y = log L(f) + log u.
            log_y = ll0 + torch.log(u)
            t_min, t_max = theta - two_pi, theta

            def point(th):
                """Positions on the ellipse at angles ``th``."""
                out = {}
                for k, fv in f.items():
                    shape = th.shape + (1,) * (fv.ndim - th.ndim)
                    out[k] = (fv * torch.cos(th).reshape(shape)
                              + nu[k] * torch.sin(th).reshape(shape))
                return out

            accepted = torch.zeros(chain_shape, dtype=torch.bool,
                                   device=device)
            f_out, ll_out = dict(f), ll0
            n_shrinks = 0
            while n_shrinks < self._max_shrink and not bool(accepted.all()):
                f_prop = point(theta)
                ll_prop = log_lik_fn(f_prop)
                ok = ~accepted & (ll_prop > log_y)
                for k, new in f_prop.items():
                    mask = ok.reshape(ok.shape + (1,) * (new.ndim - ok.ndim))
                    f_out[k] = torch.where(mask, new, f_out[k])
                ll_out = torch.where(ok, ll_prop, ll_out)
                accepted = accepted | ok
                # Shrink the bracket toward 0 for the chains still rejected.
                t_min = torch.where(~accepted & (theta < 0.0), theta, t_min)
                t_max = torch.where(~accepted & (theta >= 0.0), theta, t_max)
                s = shrink_u[n_shrinks] if noise is not None else torch.rand(
                    chain_shape, generator=generator, dtype=dtype,
                    device=device)
                theta = torch.where(accepted, theta,
                                    t_min + s * (t_max - t_min))
                n_shrinks += 1
        new_state = EllipticalSliceState(f=f_out, log_lik=ll_out,
                                         t=state.t + 1)
        return new_state, EllipticalSliceInfo(samples=f_out, log_lik=ll_out,
                                              n_shrinks=n_shrinks)

    def run(self, meta_bn, observed, state: EllipticalSliceState, generator,
            n_iters: int, collect: bool = True, *, noise=None):
        """``n_iters`` transitions in a Python loop over :meth:`sample`.

        :param noise: testing hook: a sequence of ``n_iters`` of
            :meth:`sample`'s ``noise`` tuples.
        :return: ``(final_state, {"samples", "log_lik", "n_shrinks"} or
            None)``: iteration-major tensors in preallocated buffers
            (``n_shrinks`` an int64 tensor on the host).
        """
        n_iters = int(n_iters)
        outs = None
        if collect:
            outs = {"samples": {k: v.new_empty((n_iters,) + tuple(v.shape))
                                for k, v in state.f.items()},
                    "n_shrinks": torch.empty((n_iters,), dtype=torch.int64)}
        for i in range(n_iters):
            state, info = self.sample(
                meta_bn, observed, state, generator,
                noise=None if noise is None else noise[i])
            if collect:
                for k, v in info.samples.items():
                    outs["samples"][k][i].copy_(v)
                if "log_lik" not in outs:
                    outs["log_lik"] = info.log_lik.new_empty(
                        (n_iters,) + tuple(info.log_lik.shape))
                outs["log_lik"][i].copy_(info.log_lik)
                outs["n_shrinks"][i] = info.n_shrinks
        return state, outs


def state_from_numpy(numpy_state, device=None,
                     dtype=None) -> EllipticalSliceState:
    """A port :class:`EllipticalSliceState` from a JAX one whose leaves went
    through ``np.asarray``, on ``device`` (the card when None) in ``dtype``
    (the arrays' own when None)."""
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)

    def arr(v):
        return torch.tensor(np.array(v), dtype=dtype, device=device)

    return EllipticalSliceState(
        f={k: arr(v) for k, v in numpy_state.f.items()},
        log_lik=arr(numpy_state.log_lik), t=int(np.asarray(numpy_state.t)))


def state_to_numpy(state: EllipticalSliceState) -> EllipticalSliceState:
    """The state with numpy leaves (``t`` an int32 scalar), ready for
    ``zhusuan_tpu.mcmc.elliptical.EllipticalSliceState(*...)``."""

    def arr(v):
        return v.detach().cpu().numpy()

    return EllipticalSliceState(
        f={k: arr(v) for k, v in state.f.items()},
        log_lik=arr(state.log_lik), t=np.asarray(state.t, np.int32))
