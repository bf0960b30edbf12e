"""ChEES-HMC: cross-chain adaptive trajectory-length HMC (port of
``zhusuan_tpu/mcmc/chees.py``).

ChEES (Hoffman, Radul & Sountsov, AISTATS 2021) tunes the total
integration time ``T`` by Adam on ``log T`` along the gradient of the
Change in the Estimator of the Expected Square jump distance, which uses
only per-chain quantities and two cross-chain means. Every chain runs the
same jittered trajectory length ``h_t T`` (``h_t`` the base-2 Halton
sequence of the iteration counter), so the whole state stays one
``[n_chains, ...]`` tensor program; the step size is tuned by the same
dual averaging as :class:`~zhusuan_tpu_torch.mcmc.hmc.HMC`, toward a
target for the harmonic-mean acceptance across chains.

``state.t`` is a host int, so the Halton jitter is computed on the host.
The leapfrog count ``clip(ceil(h_t T / eps), 1, max_leapfrogs)`` is a
device value. On a CUDA device, a single ``[n_chains, dim]`` float32
latent under a built-in density (:mod:`~zhusuan_tpu_torch.ops.densities`)
takes the hand-written CUDA kernel
(:func:`~zhusuan_tpu_torch.ops.chees_step.fused_chees_step`), which reads
the count on the device: the loop over iterations never waits for the
card. Everything else takes the plain path, which reads the count to the
host (one host sync per iteration) to run the trajectory
(:func:`~zhusuan_tpu_torch.mcmc.base.hmc_transition`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import (
    _select,
    adapt_span,
    dual_averaging_update,
    hmc_transition,
    make_grad_fn,
    make_log_joint_fn,
    run_driver,
    tree_random_momentum,
    tree_velocity,
)
from zhusuan_tpu_torch.mcmc.hmc import (
    _to_tensor,
    builtin_density_ineligible,
    use_kernel,
)
from zhusuan_tpu_torch.ops import chees_step
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator
from zhusuan_tpu_torch.ops.chees_step import (
    MAX_DIM,
    chees_step_supported,
    fused_chees_step,
)
from zhusuan_tpu_torch.ops.densities import BuiltinDensity
from zhusuan_tpu_torch.profiling import span

__all__ = ["ChEESHMC", "ChEESState", "ChEESInfo", "state_from_numpy",
           "state_to_numpy"]

Latent = Dict[str, torch.Tensor]


class ChEESState(NamedTuple):
    """Explicit sampler state (one chain axis: ``q[name]`` is
    ``[n_chains] + data_shape``). ``t`` is a host int."""

    q: Latent
    t: int
    step_size: torch.Tensor
    # Dual-averaging state of the step size (reference hmc.py:82-87).
    da_step: torch.Tensor
    h_bar: torch.Tensor
    log_epsilon_bar: torch.Tensor
    # Trajectory-length adaptation: Adam on log T.
    log_traj: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor


class ChEESInfo(NamedTuple):
    samples: Latent
    acceptance_rate: torch.Tensor
    step_size: torch.Tensor
    trajectory_length: torch.Tensor
    n_leapfrogs: torch.Tensor
    log_prob: torch.Tensor


def _halton2(t: int) -> float:
    """Base-2 radical inverse (Halton sequence) of the counter ``t`` taken
    as a uint32: its bit reversal as a fraction in [0, 1), exact in
    float64."""
    t = int(t) & 0xFFFFFFFF
    t = ((t & 0x55555555) << 1) | ((t >> 1) & 0x55555555)
    t = ((t & 0x33333333) << 2) | ((t >> 2) & 0x33333333)
    t = ((t & 0x0F0F0F0F) << 4) | ((t >> 4) & 0x0F0F0F0F)
    t = ((t & 0x00FF00FF) << 8) | ((t >> 8) & 0x00FF00FF)
    t = ((t << 16) | (t >> 16)) & 0xFFFFFFFF
    return t * 2.0 ** -32


def _round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (as ``.astype(dtype)``), as a Python
    float."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class ChEESHMC:
    """Adaptive-trajectory-length HMC (ChEES).

    :param step_size: initial leapfrog step size.
    :param trajectory_length: initial total integration time ``T`` (the
        per-iteration length is ``h_t T`` with Halton jitter ``h_t``).
    :param target_acceptance_rate: dual-averaging target for the
        harmonic-mean acceptance; the paper recommends ~0.651 for jittered
        HMC.
    :param traj_learning_rate: Adam learning rate on ``log T``.
    :param max_leapfrogs: cap on the per-iteration leapfrog count.
    :param gamma, t0, kappa: dual-averaging constants (reference
        hmc.py:89-112 values).
    :param experimental_fused_step: ``"auto"`` (default) runs the whole
        transition in the CUDA kernel whenever it is eligible (see the
        module docstring) and the plain path otherwise; ``False`` always
        takes the plain path; ``True`` requires the kernel for CUDA
        tensors and raises when they are not eligible. CPU tensors always
        take the plain path.
    """

    def __init__(
        self,
        step_size: float = 0.1,
        trajectory_length: float = 1.0,
        target_acceptance_rate: float = 0.651,
        traj_learning_rate: float = 0.05,
        max_leapfrogs: int = 1000,
        gamma: float = 0.05,
        t0: float = 100.0,
        kappa: float = 0.75,
        experimental_fused_step="auto",
    ):
        self.init_step_size = float(step_size)
        self.init_traj = float(trajectory_length)
        self.target_acceptance_rate = float(target_acceptance_rate)
        self.traj_lr = float(traj_learning_rate)
        self.max_leapfrogs = int(max_leapfrogs)
        self.gamma = float(gamma)
        self.t0 = float(t0)
        self.kappa = float(kappa)
        if experimental_fused_step not in (True, False, "auto"):
            raise ValueError(
                "experimental_fused_step must be True, False, or 'auto'.")
        self.experimental_fused_step = experimental_fused_step
        self.mu = float(np.log(10.0 * step_size))

    # ------------------------------------------------------------------ #
    def init(self, latent: Latent) -> ChEESState:
        """The initial :class:`ChEESState` at positions ``latent``."""
        q = {k: torch.as_tensor(v) for k, v in latent.items()}
        dtype = q[next(iter(q))].dtype
        for v in q.values():
            dtype = torch.promote_types(dtype, v.dtype)
        device = next(iter(q.values())).device

        def scalar(value):
            return torch.tensor(value, dtype=dtype, device=device)

        return ChEESState(
            q=q,
            t=0,
            step_size=scalar(self.init_step_size),
            da_step=scalar(0.0),
            h_bar=scalar(0.0),
            log_epsilon_bar=scalar(0.0),
            log_traj=scalar(math.log(self.init_traj)),
            adam_m=scalar(0.0),
            adam_v=scalar(0.0),
            adam_t=scalar(0.0),
        )

    # ------------------------------------------------------------------ #
    @staticmethod
    def _fused_ineligible(meta_bn, observed, q, mass, n_chain_dims):
        """Why the kernel cannot take this transition (None if it can)."""
        return builtin_density_ineligible(
            meta_bn, observed, q, mass, n_chain_dims, chees_step_supported,
            chees_step.DENSITIES, "float32 with dim <= {}".format(MAX_DIM))

    def _use_fused_step(self, meta_bn, observed, q, mass):
        return use_kernel(self.experimental_fused_step, q,
                          lambda: self._fused_ineligible(
                              meta_bn, observed, q, mass, 1))

    @staticmethod
    def _unit_mass(q, dtype) -> Latent:
        return {k: torch.ones((1,) + tuple(v.shape[1:]), dtype=dtype,
                              device=v.device) for k, v in q.items()}

    def _chees_grad(self, q, new_q, new_p, mass, accept_prob, jitter):
        """Per-iteration stochastic gradient of ChEES with respect to
        ``log T`` (paper Eq. 14): proposals weighted by their acceptance
        probability; d(endpoint)/d(time) is the endpoint velocity. A
        divergent trajectory (inf in the endpoint, 0 weight) contributes 0,
        not ``0 * inf = NaN``, which would poison Adam for good."""
        names = sorted(q)

        def flat(tree):
            return torch.cat([tree[k].reshape(tree[k].shape[0], -1)
                              for k in names], dim=1)

        flat_q, flat_nq = flat(q), flat(new_q)
        flat_nv = flat(tree_velocity(new_p, mass))
        w = accept_prob / torch.clamp(torch.sum(accept_prob), min=1e-12)
        mean_q = torch.sum(w[:, None] * flat_q, dim=0, keepdim=True)
        mean_nq = torch.sum(w[:, None] * flat_nq, dim=0, keepdim=True)
        dq = flat_nq - mean_nq
        jump = torch.sum(dq * dq, dim=1) - torch.sum(
            (flat_q - mean_q) ** 2, dim=1)
        djump_dt = 2.0 * torch.sum(dq * flat_nv, dim=1)
        grad = torch.sum(w * jump * djump_dt) * jitter
        return torch.where(torch.isfinite(grad), grad,
                           torch.zeros_like(grad))

    def _n_steps(self, traj_time, step_size):
        """``clip(ceil(traj_time / step_size), 1, max_leapfrogs)`` as a
        device int32. Clamped in floating point before the cast (a
        float -> int32 cast of an out-of-range value is undefined in
        torch, where XLA saturates); NaN gives 1, as XLA's cast to 0 and
        the clip do."""
        r = torch.nan_to_num(torch.ceil(traj_time / step_size), nan=1.0)
        return torch.clamp(r, 1, self.max_leapfrogs).to(torch.int32)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def sample(self, meta_bn, observed, state: ChEESState, key=None,
               adapt=True, cache=None, *, noise=None):
        """One ChEES-HMC iteration: ``(state, key) -> (state, info)``.

        :param meta_bn: ``meta_bn(obs_dict)`` callable, e.g. a
            built-in density of :mod:`~zhusuan_tpu_torch.ops.densities`,
            or a :class:`~zhusuan_tpu_torch.framework.MetaBayesianNet`.
        :param observed: dict of observations.
        :param state: current :class:`ChEESState`.
        :param key: key ``(k0, k1)`` or a ``torch.Generator`` to draw one
            from; the draws of iteration ``t`` depend only on the key and
            ``t``, so one key serves a whole run.
        :param adapt: bool (or bool tensor) gating the step-size and
            trajectory-length adaptation. When False, the step size is
            ``exp(log_epsilon_bar)`` and ``log T`` is still clipped to
            ``[log eps, log(eps max_leapfrogs)]`` against it.
        :param cache: optional ``(log_prob, None)`` at ``state.q``; the
            plain path then skips re-evaluating the density there, and the
            kept point's ``(log_prob, None)`` is returned as a third
            element.
        :param noise: testing hook: ``(eps, u)``, standard normals shaped
            like the latent (a dict, or a tensor for a single latent) and
            per-chain uniforms, replacing the momentum and MH draws.
        :return: ``(new_state, ChEESInfo)``, plus the new cache when
            ``cache`` was given.
        """
        log_post = make_log_joint_fn(meta_bn, observed)
        q = state.q
        old_lp_pre = None
        if cache is not None:
            n_chain_dims = cache[0].ndim
        elif (len(q) == 1 and isinstance(meta_bn, BuiltinDensity)
              and meta_bn.name in q):
            n_chain_dims = q[meta_bn.name].ndim - 1
        else:
            old_lp_pre = log_post(q)
            n_chain_dims = old_lp_pre.ndim
        if n_chain_dims != 1:
            raise ValueError(
                "ChEESHMC requires exactly one chain axis (log-joint "
                "output rank 1); got chain rank {}.".format(n_chain_dims))

        dtype = state.step_size.dtype
        mass = self._unit_mass(q, dtype)
        with span("zs.transition"):
            # Jittered trajectory time and the leapfrog count (a device
            # value).
            with span("zs.chees.jitter"):
                jitter = max(_round_to(_halton2(state.t), dtype),
                             1.0 / 64.0)
            traj_time = jitter * torch.exp(state.log_traj)
            eps = state.step_size
            n_steps = self._n_steps(traj_time, eps)

            eps_in = u_in = None
            if noise is not None:
                eps_in, u_in = noise
                if isinstance(eps_in, torch.Tensor):
                    (name,) = q
                    eps_in = {name: eps_in}
            # With injected noise and no key, the kernel's Philox is
            # unused.
            key = ((0, 0) if noise is not None and key is None
                   else as_key(key))
            new_t = state.t + 1

            if self._use_fused_step(meta_bn, observed, q, mass):
                ((name, x),) = q.items()
                (out_q, prop_q, prop_p, accept_prob, _,
                 sel_log_prob) = fused_chees_step(
                    meta_bn, x, mass[name], eps, n_steps, key, new_t,
                    noise=None if noise is None else (eps_in[name], u_in))
                accepted_q = {name: out_q}
                new_q, new_p = {name: prop_q}, {name: prop_p}
            else:
                x0 = q[next(iter(q))]
                gen = (None if noise is not None
                       else iteration_generator(key, new_t, x0.device))
                p = tree_random_momentum(gen, q, mass, eps_in)
                if u_in is None:
                    u_in = torch.rand(x0.shape[:1], generator=gen,
                                      dtype=dtype, device=x0.device)
                old_lp = cache[0] if cache is not None else old_lp_pre
                # The plain trajectory is a Python loop: the count goes to
                # the host (one sync per iteration).
                with span("zs.sync.chees_leapfrogs"):
                    n_leapfrogs = int(n_steps)
                (accepted_q, accept_prob, _, sel_log_prob, _, _, _, new_q,
                 new_p) = hmc_transition(
                    q, p, u_in, eps, n_leapfrogs, make_grad_fn(log_post),
                    log_post, mass, 1, old_lp)

        # Pin the adaptation math to the state dtype (JAX fix de43ee6).
        accept_prob = accept_prob.to(dtype)
        # Harmonic-mean acceptance across chains (Hoffman et al. 2021):
        # the statistic the step size is dual-averaged on.
        with adapt_span("zs.adapt.step_size", adapt):
            harmonic_accept = 1.0 / torch.mean(
                1.0 / torch.clamp(accept_prob, min=1e-10))
            step_size, new_da_step, new_h_bar, new_log_eps_bar = (
                dual_averaging_update(
                    state.da_step, state.h_bar, state.log_epsilon_bar,
                    state.step_size, harmonic_accept, adapt,
                    fresh_start=state.da_step == 0,
                    mu=self.mu, target=self.target_acceptance_rate,
                    gamma=self.gamma, t0=self.t0, kappa=self.kappa,
                ))

        # --- trajectory-length Adam on the ChEES gradient --------------- #
        with adapt_span("zs.adapt.trajectory", adapt):
            if adapt is False:
                m, v, adam_t, log_traj = (state.adam_m, state.adam_v,
                                          state.adam_t, state.log_traj)
            else:
                g_traj = self._chees_grad(q, new_q, new_p, mass,
                                          accept_prob, jitter)
                b1, b2 = 0.9, 0.95
                adam_t = state.adam_t + (1.0 if adapt is True
                                         else adapt.to(dtype))
                m = _select(adapt, b1 * state.adam_m + (1 - b1) * g_traj,
                            state.adam_m)
                v = _select(adapt,
                            b2 * state.adam_v + (1 - b2) * g_traj ** 2,
                            state.adam_v)
                safe_t = torch.clamp(adam_t, min=1.0)
                m_hat = m / (1 - b1 ** safe_t)
                v_hat = v / (1 - b2 ** safe_t)
                delta = self.traj_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
                # Ascent on ChEES; clipped so one noisy iteration cannot
                # explode T.
                delta = torch.clamp(delta, -0.5, 0.5)
                log_traj = _select(adapt, state.log_traj + delta,
                                   state.log_traj)
            # Keep T within [eps, max_leapfrogs eps], also when frozen.
            log_traj = torch.clamp(
                log_traj, min=torch.log(step_size),
                max=torch.log(step_size * self.max_leapfrogs))

        new_state = ChEESState(
            q=accepted_q,
            t=new_t,
            step_size=step_size.to(dtype),
            da_step=new_da_step,
            h_bar=new_h_bar,
            log_epsilon_bar=new_log_eps_bar,
            log_traj=log_traj.to(dtype),
            adam_m=m,
            adam_v=v,
            adam_t=adam_t,
        )
        info = ChEESInfo(
            samples=accepted_q,
            acceptance_rate=accept_prob,
            step_size=step_size,
            trajectory_length=torch.exp(log_traj),
            n_leapfrogs=n_steps,
            log_prob=sel_log_prob,
        )
        if cache is not None:
            return new_state, info, (sel_log_prob, None)
        return new_state, info

    # ------------------------------------------------------------------ #
    def run(self, meta_bn, observed, state: ChEESState, key, n_iters: int,
            n_adapt: int = 0, collect: bool = True):
        """Run ``n_iters`` iterations in a Python loop over :meth:`sample`.
        Adaptation (step size and trajectory length) is gated on for the
        iterations with ``state.t < n_adapt`` and frozen after.

        The key is drawn once, here, from ``key`` (a ``torch.Generator`` or
        a ``(k0, k1)`` pair); each iteration's draws follow from it and the
        host-int ``state.t``. The plain path carries the density value at
        the current position; the kernel evaluates it in registers.

        :return: ``(final_state, outputs)``; ``outputs`` holds
            iteration-major ``samples`` (a dict), ``acceptance_rate``,
            ``trajectory_length`` and ``n_leapfrogs``, written into
            preallocated buffers, when ``collect`` else None.
        """
        key = as_key(key)
        log_post = make_log_joint_fn(meta_bn, observed)
        kernel = self._use_fused_step(
            meta_bn, observed, state.q,
            self._unit_mass(state.q, state.step_size.dtype))
        cache = None if kernel else (log_post(state.q), None)

        def one(st, i):
            nonlocal cache
            st, info, *rest = self.sample(
                meta_bn, observed, st, key,
                adapt=n_adapt > 0 and st.t < n_adapt, cache=cache)
            cache = rest[0] if rest else None
            return st, info

        def pick(info):
            return {"samples": info.samples,
                    "acceptance_rate": info.acceptance_rate,
                    "trajectory_length": info.trajectory_length,
                    "n_leapfrogs": info.n_leapfrogs}

        return run_driver(one, pick, state, n_iters, collect, 1)


# ---------------------------------------------------------------------- #
def state_from_numpy(numpy_state, device=None, dtype=None) -> ChEESState:
    """Build the port's :class:`ChEESState` from a JAX ``ChEESState`` whose
    leaves were converted with ``np.asarray`` (any object with the same
    field names). ``dtype`` None keeps the arrays' own dtypes."""
    s = numpy_state

    def arr(v):
        return _to_tensor(v, device, dtype)

    return ChEESState(
        q={k: arr(v) for k, v in s.q.items()},
        t=int(np.asarray(s.t)),
        **{f: arr(getattr(s, f)) for f in ChEESState._fields[2:]},
    )


def state_to_numpy(state: ChEESState) -> ChEESState:
    """The port's state with numpy leaves (``t`` as an int32 scalar), ready
    for ``zhusuan_tpu.mcmc.chees.ChEESState(*...)``."""

    def arr(v):
        return v.detach().cpu().numpy()

    return ChEESState(
        q={k: arr(v) for k, v in state.q.items()},
        t=np.asarray(state.t, np.int32),
        **{f: arr(getattr(state, f)) for f in ChEESState._fields[2:]},
    )
