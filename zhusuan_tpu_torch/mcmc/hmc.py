"""Hamiltonian Monte Carlo with dual-averaging step-size and mass-matrix
adaptation (port of ``zhusuan_tpu/mcmc/hmc.py``).

Capability parity with reference ``zhusuan/hmc.py``: the ``StepsizeTuner``
Nesterov dual averaging (hmc.py:64-112), the
``ExponentialWeightedMovingVariance`` diagonal mass adaptation
(hmc.py:115-159), the heuristic initial step-size search (hmc.py:307-345),
the boundary-aware leapfrog loop (hmc.py:347-372), the per-chain MH test
with non-finite -> reject (hmc.py:479-498), and ``HMCInfo`` statistics
(hmc.py:162-201).

The sampler state is the explicit :class:`HMCState` of tensors; one
iteration is ``sample(state, key) -> (state, info)``, and ``run`` is a
Python loop over it. ``state.t`` is a host int, so the iteration-dependent
decisions (the init step-size search at ``t == 1`` and
``t == mass_collect_iters``, the adaptation gate ``t < n_adapt``, the
random-number counter) never read the device. The only host syncs in ``run`` are
the init step-size search's trials.

On a CUDA device, a single ``[n_chains, dim]`` float32/bfloat16 latent
under a built-in density (:mod:`~zhusuan_tpu_torch.ops.densities`: the
diagonal or the equicorrelated Gaussian) takes the hand-written CUDA
kernel (:func:`~zhusuan_tpu_torch.ops.hmc_step.fused_hmc_step`) for the
whole transition. With ``experimental_fused_leapfrog=True``, a transition
that does not take it runs its trajectory through the trajectory kernel
(:func:`~zhusuan_tpu_torch.ops.leapfrog.fused_leapfrog`) when that is
eligible. Everything else takes the plain torch path.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import (
    dual_averaging_update,
    ewmv_update,
    get_acceptance_rate,
    hmc_transition,
    leapfrog_step,
    leapfrog_trajectory,
    leapfrog_trajectory_cached,
    make_grad_fn,
    make_log_joint_fn,
    tree_random_momentum,
)
from zhusuan_tpu_torch.ops import hmc_step, leapfrog
from zhusuan_tpu_torch.ops._random import iteration_generator, philox_key
from zhusuan_tpu_torch.ops.densities import BuiltinDensity
from zhusuan_tpu_torch.ops.hmc_step import (
    MAX_DIM,
    fused_hmc_step,
    hmc_step_supported,
)
from zhusuan_tpu_torch.ops.leapfrog import fused_leapfrog, leapfrog_supported

__all__ = ["HMC", "HMCState", "HMCInfo", "state_from_numpy",
           "state_to_numpy"]

Latent = Dict[str, torch.Tensor]


class HMCState(NamedTuple):
    """Explicit sampler state (replaces the reference's tf.Variables,
    hmc.py:219-222,258-264). ``t`` is a host int."""

    q: Latent
    t: int
    step_size: torch.Tensor
    da_step: torch.Tensor
    h_bar: torch.Tensor
    log_epsilon_bar: torch.Tensor
    ewmv_t: torch.Tensor
    ewmv_mean: Latent
    ewmv_var: Latent
    mass: Latent


class HMCInfo(NamedTuple):
    """Per-iteration statistics (parity: reference ``HMCInfo``
    hmc.py:162-201)."""

    samples: Latent
    acceptance_rate: torch.Tensor
    updated_step_size: torch.Tensor
    init_momentum: Latent
    orig_hamiltonian: torch.Tensor
    hamiltonian: torch.Tensor
    orig_log_prob: torch.Tensor
    log_prob: torch.Tensor


def _as_key(key):
    """A key ``(k0, k1)`` from a ``torch.Generator``, a ``(k0, k1)``
    pair, or None (the default CPU generator)."""
    if key is None or isinstance(key, torch.Generator):
        return philox_key(key)
    k0, k1 = key
    return int(k0), int(k1)


class HMC:
    """Hamiltonian Monte Carlo sampler.

    :param step_size: initial leapfrog step size.
    :param n_leapfrogs: number of leapfrog steps per iteration.
    :param adapt_step_size: None disables dual averaging; a bool enables it
        and sets the default gate (override per call with
        ``sample(..., adapt_step_size=flag)``).
    :param target_acceptance_rate: dual-averaging target (delta).
    :param gamma, t0, kappa: dual-averaging hyperparameters (Hoffman &
        Gelman 2014; reference hmc.py:89-112).
    :param adapt_mass: None disables mass adaptation; a bool enables the EW
        variance machinery and sets the default gate. Requires
        ``adapt_step_size`` (reference hmc.py:270-272).
    :param mass_collect_iters: iterations before the adapted mass is used
        (forced to 0 when ``adapt_mass`` is None, as in the reference).
    :param mass_decay: EW variance decay.
    :param experimental_fused_leapfrog: when the whole-step kernel is not
        taken, run the trajectory through the trajectory kernel
        (:func:`~zhusuan_tpu_torch.ops.leapfrog.fused_leapfrog`) if it is
        eligible: CUDA, a built-in density over a single ``[n_chains,
        dim]`` float32 latent with one chain axis, ``[1, dim]`` float32
        mass. Otherwise the plain trajectory runs. :meth:`run` then carries
        no density cache, as in the JAX package.
    :param experimental_fused_step: ``"auto"`` (default) runs the whole
        transition in the CUDA kernel whenever it is eligible (see the
        module docstring) and the plain path otherwise; ``False`` always
        takes the plain path; ``True`` requires the kernel for CUDA
        tensors and raises when they are not eligible. CPU tensors always
        take the plain path.
    """

    def __init__(
        self,
        step_size: float = 1.0,
        n_leapfrogs: int = 10,
        adapt_step_size: Optional[bool] = None,
        target_acceptance_rate: float = 0.8,
        gamma: float = 0.05,
        t0: float = 100.0,
        kappa: float = 0.75,
        adapt_mass: Optional[bool] = None,
        mass_collect_iters: int = 10,
        mass_decay: float = 0.99,
        experimental_fused_leapfrog: bool = False,
        experimental_fused_step="auto",
    ):
        self.init_step_size = float(step_size)
        self.n_leapfrogs = int(n_leapfrogs)
        self.adapt_step_size = adapt_step_size
        self.target_acceptance_rate = float(target_acceptance_rate)
        self.gamma = float(gamma)
        self.t0 = float(t0)
        self.kappa = float(kappa)
        # mu = log(10 * eps0), the dual-averaging attractor (Hoffman &
        # Gelman's published recipe; see zhusuan_tpu/mcmc/hmc.py:148-153).
        self.mu = float(math.log(10.0 * step_size))
        if adapt_mass is not None and adapt_step_size is None:
            raise ValueError(
                "adapt_mass requires adapt_step_size "
                "(parity: reference hmc.py:270-272)."
            )
        self.adapt_mass = adapt_mass
        # Without mass adaptation there is no second init-search trigger
        # (reference hmc.py:275-277 zeroes mass_collect_iters).
        self.mass_collect_iters = (
            int(mass_collect_iters) if adapt_mass is not None else 0
        )
        self.mass_decay = float(mass_decay)
        self.experimental_fused_leapfrog = bool(experimental_fused_leapfrog)
        if experimental_fused_step not in (True, False, "auto"):
            raise ValueError(
                "experimental_fused_step must be True, False, or 'auto'."
            )
        self.experimental_fused_step = experimental_fused_step

    # ------------------------------------------------------------------ #
    @staticmethod
    def _fused_ineligible(log_joint, observed, q, mass, n_chain_dims):
        """Why the kernel cannot take this transition (None if it can)."""
        return builtin_density_ineligible(
            log_joint, observed, q, mass, n_chain_dims, hmc_step_supported,
            hmc_step.DENSITIES,
            "float32/bfloat16 with dim <= {}".format(MAX_DIM))

    def _use_fused_step(self, log_joint, observed, q, mass, n_chain_dims):
        return use_kernel(self.experimental_fused_step, q,
                          lambda: self._fused_ineligible(
                              log_joint, observed, q, mass, n_chain_dims))

    def _fused_trajectory(self, log_joint, observed, q, mass, n_chain_dims):
        """The trajectory kernel as a ``trajectory`` of
        :func:`..base.hmc_transition`, or None when the flag is off, the
        tensors are not on a CUDA device or the kernel is ineligible."""
        if not (self.experimental_fused_leapfrog
                and any(v.is_cuda for v in q.values())):
            return None
        if builtin_density_ineligible(
                log_joint, observed, q, mass, n_chain_dims,
                leapfrog_supported, leapfrog.DENSITIES,
                "float32 with dim <= {}".format(MAX_DIM)) is not None:
            return None
        ((name, _),) = q.items()

        def trajectory(q, p, step_size, n_leapfrogs):
            nq, np_ = fused_leapfrog(log_joint, q[name], p[name], step_size,
                                     n_leapfrogs, mass[name])
            return {name: nq}, {name: np_}

        return trajectory

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init(self, latent: Latent, n_chain_dims: Optional[int] = None,
             log_joint=None, observed=None) -> HMCState:
        """Create the initial :class:`HMCState` from initial positions.

        :param latent: dict of initial chain positions, each of shape
            ``chain_axes + data_axes``.
        :param n_chain_dims: number of leading chain axes. If None, it is
            the rank of ``log_joint``'s output (which then must be given).
        """
        return init_state(latent, self.init_step_size, n_chain_dims,
                          log_joint, observed)

    # ------------------------------------------------------------------ #
    def _init_step_size_search(self, q, p, mass, grad_fn, log_post,
                               n_chain_dims, current_step_size):
        """Heuristic initial step-size search: scale by 1.5 up or down until
        the mean acceptance crosses the target (reference hmc.py:307-345).
        A data-dependent host loop: one host sync per trial."""
        factor = 1.5
        target = self.target_acceptance_rate

        def trial_acceptance(step_size):
            nq, np_ = leapfrog_step(q, p, 0.0, step_size / 2, grad_fn, mass)
            nq, np_ = leapfrog_step(nq, np_, step_size, step_size / 2,
                                    grad_fn, mass)
            *_, acc = get_acceptance_rate(q, p, nq, np_, log_post, mass,
                                          n_chain_dims)
            return torch.mean(acc)

        step_size = current_step_size
        last_below = 1.0 < target
        while True:
            acc = trial_acceptance(step_size).to(step_size.dtype)
            below = bool(acc < target)
            new_step_size = (step_size / factor if below
                             else step_size * factor)
            go = last_below == below
            step_size, last_below = new_step_size, below
            if not go:
                return step_size

    def _leapfrog(self, q, p, step_size, grad_fn, mass):
        """n_leapfrogs+1 boundary-aware sub-steps (reference
        hmc.py:347-372)."""
        return leapfrog_trajectory(q, p, step_size, self.n_leapfrogs,
                                   grad_fn, mass)

    def _leapfrog_cached(self, q, p, step_size, grad_fn, mass, g0):
        """The trajectory of :meth:`_leapfrog` with the gradient at ``q``
        supplied (``g0``) and the end point's gradient returned:
        ``n_leapfrogs`` gradient evaluations instead of
        ``n_leapfrogs + 1``."""
        return leapfrog_trajectory_cached(q, p, step_size, self.n_leapfrogs,
                                          grad_fn, mass, g0)

    def _tune_step_size(self, state: HMCState, acceptance_rate, gate,
                        fresh_start):
        """Nesterov dual averaging (reference hmc.py:89-112), delegating to
        :func:`..base.dual_averaging_update`."""
        return dual_averaging_update(
            state.da_step, state.h_bar, state.log_epsilon_bar,
            state.step_size, acceptance_rate, gate, fresh_start,
            mu=self.mu, target=self.target_acceptance_rate,
            gamma=self.gamma, t0=self.t0, kappa=self.kappa,
        )

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def sample(self, log_joint, observed, state: HMCState, key=None,
               adapt_step_size=None, adapt_mass=None, cache=None, *,
               noise=None):
        """Run ONE HMC iteration: ``(state, key) -> (state, info)``.

        :param log_joint: ``log_joint(obs_dict)`` callable, e.g. a
            built-in density of :mod:`~zhusuan_tpu_torch.ops.densities`.
        :param observed: dict of observations.
        :param state: current :class:`HMCState`.
        :param key: key ``(k0, k1)`` or a ``torch.Generator`` to draw one
            from. The draws of iteration ``t`` depend only on the key and
            ``t`` (the kernel's Philox counter word, or the seed of the
            plain path's generator), so one key serves a whole run.
        :param adapt_step_size: optional bool (or bool tensor) gating
            step-size adaptation this iteration (default: the constructor
            setting).
        :param adapt_mass: optional bool gating mass adaptation.
        :param cache: optional ``(log_prob, grad_dict)`` at ``state.q``
            (:meth:`make_cache`); the iteration then skips re-evaluating
            both, and returns the cache of the kept position as a third
            element. ``grad_dict`` may be None (value-only cache).
        :param noise: testing hook: ``(eps, u)``, standard normals shaped
            like the latent (a dict, or a tensor for a single latent) and
            chain-shaped uniforms, replacing the momentum and MH draws.
        :return: ``(new_state, HMCInfo)``, plus ``new_cache`` when
            ``cache`` was given.
        """
        log_post = make_log_joint_fn(log_joint, observed)
        grad_fn = make_grad_fn(log_post)
        state_dtypes = {k: v.dtype for k, v in state.q.items()}
        # bf16 state: compute in f32, round back at the state write.
        q = {k: (v.float() if v.dtype == torch.bfloat16 else v)
             for k, v in state.q.items()}
        x0 = q[next(iter(q))]
        eps = u_in = gen = None
        if noise is not None:
            eps, u_in = noise
            if isinstance(eps, torch.Tensor):
                (name,) = q
                eps = {name: eps}
        else:
            key = _as_key(key)

        old_lp_pre = None
        if cache is not None:
            n_chain_dims = cache[0].ndim
        elif (len(q) == 1 and isinstance(log_joint, BuiltinDensity)
              and log_joint.name in q):
            n_chain_dims = q[log_joint.name].ndim - 1
        else:
            old_lp_pre = log_post(q)
            n_chain_dims = old_lp_pre.ndim

        new_t = state.t + 1

        # --- mass adaptation (reference hmc.py:283-305,452-456) -------- #
        if self.adapt_mass is not None:
            gate_mass = (adapt_mass if adapt_mass is not None
                         else self.adapt_mass)
            ewmv_t, ewmv_mean, ewmv_var, mass = mass_update(
                state, gate_mass, n_chain_dims, self.mass_decay,
                self.mass_collect_iters)
        else:
            ewmv_t, ewmv_mean, ewmv_var = (
                state.ewmv_t, state.ewmv_mean, state.ewmv_var)
            mass = state.mass

        use_fused = self._use_fused_step(log_joint, observed, state.q, mass,
                                         n_chain_dims)
        if not (use_fused or noise is not None):
            gen = iteration_generator(key, new_t, x0.device)
        # The kernel draws its own momentum (the init search below draws
        # its own when it fires, as in the JAX package).
        p = None if use_fused else tree_random_momentum(gen, q, mass, eps)

        # --- step size (+ heuristic init search; hmc.py:458-472) ------- #
        if self.adapt_step_size is not None:
            if_init_ss = new_t == 1 or new_t == self.mass_collect_iters
            if if_init_ss:
                if use_fused and noise is None:
                    gen = iteration_generator(key, new_t, x0.device)
                p_s = (tree_random_momentum(gen, q, mass, eps)
                       if use_fused else p)
                step_size = self._init_step_size_search(
                    q, p_s, mass, grad_fn, log_post, n_chain_dims,
                    state.step_size)
            else:
                step_size = state.step_size
        else:
            if_init_ss = False
            step_size = state.step_size

        new_cache = None
        if use_fused:
            ((name, x),) = state.q.items()
            # The carried (possibly bf16) array goes in; the kernel
            # upcasts in registers.
            (out_q, p0, acceptance_rate, old_log_prob, new_log_prob, old_h,
             new_h) = fused_hmc_step(
                log_joint, x, mass[name], step_size, self.n_leapfrogs, key,
                new_t,
                noise=None if noise is None else (eps[name], u_in))
            accepted_q = {name: out_q}
            p = {name: p0}
            new_cache = (new_log_prob, None)
        else:
            old_lp_in, g0 = cache if cache is not None else (old_lp_pre,
                                                             None)
            if u_in is None:
                u_in = torch.rand(x0.shape[:n_chain_dims], generator=gen,
                                  dtype=x0.dtype, device=x0.device)
            # --- leapfrog + MH test (hmc.py:474-498) ------------------- #
            (accepted_q, acceptance_rate, old_log_prob, new_log_prob, old_h,
             new_h, accepted_g, _, _) = hmc_transition(
                q, p, u_in, step_size, self.n_leapfrogs, grad_fn, log_post,
                mass, n_chain_dims, old_lp_in, g0,
                self._fused_trajectory(log_joint, observed, q, mass,
                                       n_chain_dims))
            if cache is not None:
                new_cache = (new_log_prob, accepted_g)

        # --- step-size adaptation (hmc.py:500-505) --------------------- #
        if self.adapt_step_size is not None:
            gate_ss = (adapt_step_size if adapt_step_size is not None
                       else self.adapt_step_size)
            updated_step_size, da_step, h_bar, log_eps_bar = (
                self._tune_step_size(state, torch.mean(acceptance_rate),
                                     gate_ss, if_init_ss))
        else:
            updated_step_size = step_size
            da_step, h_bar, log_eps_bar = (
                state.da_step, state.h_bar, state.log_epsilon_bar)

        new_state = HMCState(
            q={k: v.to(state_dtypes[k]) for k, v in accepted_q.items()},
            t=new_t,
            step_size=updated_step_size,
            da_step=da_step,
            h_bar=h_bar,
            log_epsilon_bar=log_eps_bar,
            ewmv_t=ewmv_t,
            ewmv_mean=ewmv_mean,
            ewmv_var=ewmv_var,
            mass=mass,
        )
        info = HMCInfo(
            samples=accepted_q,
            acceptance_rate=acceptance_rate,
            updated_step_size=updated_step_size,
            init_momentum=p,
            orig_hamiltonian=old_h,
            hamiltonian=new_h,
            orig_log_prob=old_log_prob,
            log_prob=new_log_prob,
        )
        if cache is not None:
            return new_state, info, new_cache
        return new_state, info

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def make_cache(self, log_joint, observed, state: HMCState,
                   with_grad: bool = True):
        """Evaluate ``(log_prob, grad_dict)`` at ``state.q``: the carried
        cache that lets :meth:`sample` skip re-evaluating the density at
        the current position. With ``with_grad=False`` the grad slot is
        None."""
        log_post = make_log_joint_fn(log_joint, observed)
        logp = log_post(state.q)
        if not with_grad:
            return logp, None
        g = make_grad_fn(log_post)(state.q)
        # bf16 state: carry the gradient at compute precision (f32).
        g = {k: (v.float() if v.dtype == torch.bfloat16 else v)
             for k, v in g.items()}
        return logp, g

    # ------------------------------------------------------------------ #
    def run(
        self,
        log_joint,
        observed,
        state: HMCState,
        key,
        n_iters: int,
        n_adapt: int = 0,
        collect: bool = True,
        collect_fields=("samples", "acceptance_rate", "step_size",
                        "log_prob"),
        collect_dtype=None,
        thinning: int = 1,
    ):
        """Run ``n_iters`` iterations in a Python loop over :meth:`sample`.

        The first ``n_adapt`` iterations (by ``state.t``) have step-size and
        mass adaptation gated on, the rest off. The key is drawn
        once, here, from ``key`` (a ``torch.Generator`` or a ``(k0, k1)``
        pair); each iteration's draws follow from it and the host-int
        ``state.t``, and the loop makes no host sync except the init
        step-size search's trials.

        :param collect: stack per-iteration outputs when True; otherwise
            only the final state is returned.
        :param collect_fields: which outputs to stack (subset of
            ``samples``, ``acceptance_rate``, ``step_size``, ``log_prob``).
        :param collect_dtype: optional dtype of the stacked ``samples``
            copy (e.g. ``torch.bfloat16``); the chain advances in the state
            dtype.
        :param thinning: stack every ``thinning``-th iteration only: the
            output is the full trajectory sliced ``thinning-1::thinning``
            (``n_iters // thinning`` rows), written into preallocated
            buffers.
        :return: ``(final_state, outputs)``; ``outputs`` is a dict of
            iteration-major tensors when ``collect`` else None.
        """
        valid_fields = ("samples", "acceptance_rate", "step_size",
                        "log_prob")
        bad = [f for f in collect_fields if f not in valid_fields]
        if bad:
            raise ValueError(
                "Unknown collect_fields {}; valid names are {}.".format(
                    bad, valid_fields))
        if int(thinning) < 1:
            raise ValueError("thinning must be >= 1.")
        thinning = int(thinning)
        key = _as_key(key)
        adapt_enabled = self.adapt_step_size is not None
        # Carry (log_prob, grad) at the current position on the plain
        # path; the kernels re-evaluate in registers and ignore it, and
        # with experimental_fused_leapfrog no cache is carried (as in the
        # JAX package, mcmc/hmc.py:850-853). The mass stays [1, dim]
        # throughout, so the gate's answer for the initial state holds for
        # the whole run.
        cache = (None if self.experimental_fused_leapfrog
                 or self._use_fused_step(log_joint, observed, state.q,
                                         state.mass, 1)
                 else self.make_cache(log_joint, observed, state))
        n_out = n_iters // thinning if collect else 0
        outputs = {} if collect else None

        def pick(info):
            return {
                "samples": {n: (v.to(collect_dtype) if collect_dtype
                                else v) for n, v in info.samples.items()},
                "acceptance_rate": info.acceptance_rate,
                "step_size": info.updated_step_size,
                "log_prob": info.log_prob,
            }

        def store(row, info):
            picked = pick(info)
            for f in collect_fields:
                if f == "samples":
                    buf = outputs.setdefault(f, {})
                    for n, v in picked[f].items():
                        if n not in buf:
                            buf[n] = v.new_empty((n_out,) + tuple(v.shape))
                        buf[n][row].copy_(v)
                else:
                    v = picked[f]
                    if f not in outputs:
                        outputs[f] = v.new_empty((n_out,) + tuple(v.shape))
                    outputs[f][row].copy_(v)

        for i in range(int(n_iters)):
            if not adapt_enabled:
                gate = None
            else:
                gate = n_adapt > 0 and state.t < n_adapt
            state, info, *rest = self.sample(
                log_joint, observed, state, key,
                adapt_step_size=gate,
                adapt_mass=gate if self.adapt_mass is not None else None,
                cache=cache,
            )
            cache = rest[0] if rest else None
            row, hit = divmod(i + 1, thinning)
            if collect and hit == 0 and row <= n_out:
                store(row - 1, info)
        return state, outputs


def mass_update(state: HMCState, gate, n_chain_dims: int, decay: float,
                mass_collect_iters: int):
    """One gated EW moving-variance update over the chain axes and the mass
    iteration ``state.t + 1`` uses (reference hmc.py:115-159, 283-305): the
    inverse variance from ``mass_collect_iters`` on, once the accumulator
    has had a gated update (else var == 0 would give mass 1e20), unit mass
    before. Returns ``(ewmv_t, ewmv_mean, ewmv_var, mass)``."""
    ewmv_t, ewmv_mean, ewmv_var = ewmv_update(
        state.q, state.ewmv_t, state.ewmv_mean, state.ewmv_var, gate,
        n_chain_dims, decay)
    mass = {}
    for k in state.q:
        ones = torch.ones_like(ewmv_var[k])
        if state.t + 1 >= mass_collect_iters:
            mass[k] = torch.where(
                ewmv_t > 0, 1.0 / torch.clamp(ewmv_var[k], min=1e-20), ones)
        else:
            mass[k] = ones
    return ewmv_t, ewmv_mean, ewmv_var, mass


def builtin_density_ineligible(log_joint, observed, q, mass, n_chain_dims,
                               supported, densities, wants):
    """Why a kernel over built-in densities cannot take a transition on
    the latent dict ``q`` (None if it can). ``supported(shape, dtype)`` is
    the kernel's gate, ``densities`` the built-ins it evaluates; ``wants``
    says in words what it takes. ``mass`` is None for a sampler without
    one (SGMCMC)."""
    if len(q) != 1:
        return "the latent must be a single tensor"
    if not isinstance(log_joint, densities):
        return "the log-joint must be one of the built-in densities {}".format(
            ", ".join(c.__name__ for c in densities))
    ((name, x),) = q.items()
    if log_joint.name != name or name in (observed or {}):
        return "the built-in density must be over the latent {!r}".format(
            name)
    if n_chain_dims != 1 or not supported(x.shape, x.dtype):
        return "the latent must be [n_chains, dim] {}; got {} {}".format(
            wants, tuple(x.shape), x.dtype)
    d = x.shape[1]
    if mass is not None and (tuple(mass[name].shape) != (1, d)
                             or mass[name].dtype != torch.float32):
        return "the mass must be [1, dim] float32"
    if log_joint.dim != d:
        return "the density's dim differs from the latent's"
    return None


def use_kernel(flag, q, ineligible) -> bool:
    """The ``experimental_fused_step`` rule: ``flag`` False or CPU tensors
    take the plain path; otherwise the kernel runs when ``ineligible()``
    gives no reason, and when it gives one, ``"auto"`` takes the plain
    path and ``True`` raises."""
    if not flag or not any(v.is_cuda for v in q.values()):
        return False
    reason = ineligible()
    if reason is None:
        return True
    if flag is True:
        raise ValueError(
            "experimental_fused_step=True, but the CUDA kernel cannot take "
            "this transition: {}.".format(reason))
    return False


def init_state(latent: Latent, step_size: float,
               n_chain_dims: Optional[int] = None, log_joint=None,
               observed=None) -> HMCState:
    """The initial :class:`HMCState` of HMC and NUTS (see :meth:`HMC.init`).
    """
    q = {k: torch.as_tensor(v) for k, v in latent.items()}
    if n_chain_dims is None:
        if log_joint is None:
            raise ValueError(
                "Provide either n_chain_dims or log_joint (+observed) "
                "so the chain rank can be inferred."
            )
        log_post = make_log_joint_fn(log_joint, observed or {})
        n_chain_dims = log_post(q).ndim
    n_chain_dims = int(n_chain_dims)
    dtype = q[next(iter(q))].dtype
    for v in q.values():
        dtype = torch.promote_types(dtype, v.dtype)
    # bf16 state keeps only the positions in bf16; the adaptation
    # state stays f32.
    if dtype == torch.bfloat16:
        dtype = torch.float32
    device = next(iter(q.values())).device

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    shapes = {k: (1,) * n_chain_dims + tuple(v.shape[n_chain_dims:])
              for k, v in q.items()}
    return HMCState(
        q=q,
        t=0,
        step_size=full((), step_size),
        da_step=full((), 0.0),
        h_bar=full((), 0.0),
        log_epsilon_bar=full((), 0.0),
        ewmv_t=full((), 0.0),
        ewmv_mean={k: full(s, 0.0) for k, s in shapes.items()},
        ewmv_var={k: full(s, 0.0) for k, s in shapes.items()},
        mass={k: full(s, 1.0) for k, s in shapes.items()},
    )


# ---------------------------------------------------------------------- #
def _to_tensor(value, device, dtype):
    arr = np.array(value)  # a writable copy
    if arr.dtype.kind not in "biuf":  # e.g. ml_dtypes.bfloat16
        arr = arr.astype(np.float32)
    out = torch.as_tensor(arr, device=device)
    return out if dtype is None else out.to(dtype)


def state_from_numpy(numpy_state, device=None, dtype=None) -> HMCState:
    """Build the port's :class:`HMCState` from a JAX ``HMCState`` whose
    leaves were converted with ``np.asarray`` (any object with the same
    field names).

    :param dtype: dtype of the positions; the adaptation state takes it
        too, except that bfloat16 positions keep float32 adaptation state.
        None keeps the arrays' own dtypes.
    """
    s = numpy_state
    adapt = torch.float32 if dtype == torch.bfloat16 else dtype

    def tree(d, dt):
        return {k: _to_tensor(v, device, dt) for k, v in d.items()}

    return HMCState(
        q=tree(s.q, dtype),
        t=int(np.asarray(s.t)),
        step_size=_to_tensor(s.step_size, device, adapt),
        da_step=_to_tensor(s.da_step, device, adapt),
        h_bar=_to_tensor(s.h_bar, device, adapt),
        log_epsilon_bar=_to_tensor(s.log_epsilon_bar, device, adapt),
        ewmv_t=_to_tensor(s.ewmv_t, device, adapt),
        ewmv_mean=tree(s.ewmv_mean, adapt),
        ewmv_var=tree(s.ewmv_var, adapt),
        mass=tree(s.mass, adapt),
    )


def state_to_numpy(state: HMCState) -> HMCState:
    """The port's state with numpy leaves (bfloat16 positions as
    float32, ``t`` as an int32 scalar), ready for
    ``zhusuan_tpu.mcmc.hmc.HMCState(*...)``."""

    def arr(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()

    def tree(d):
        return {k: arr(v) for k, v in d.items()}

    return HMCState(
        q=tree(state.q),
        t=np.asarray(state.t, np.int32),
        step_size=arr(state.step_size),
        da_step=arr(state.da_step),
        h_bar=arr(state.h_bar),
        log_epsilon_bar=arr(state.log_epsilon_bar),
        ewmv_t=arr(state.ewmv_t),
        ewmv_mean=tree(state.ewmv_mean),
        ewmv_var=tree(state.ewmv_var),
        mass=tree(state.mass),
    )
