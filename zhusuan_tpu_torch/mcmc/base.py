"""Shared MCMC machinery: latent-dict handling and Hamiltonian helpers.

Port of ``zhusuan_tpu/mcmc/base.py``. Parity: the free helper functions of
reference ``zhusuan/hmc.py:21-61`` (``random_momentum``, ``velocity``,
``hamiltonian``, ``leapfrog_integrator``, ``get_acceptance_rate``) and the
step-size / mass adaptation updates (hmc.py:89-159), over latent dicts of
torch tensors.

Gates (``gate``, ``fresh_start``) may be Python bools or bool tensors. A
Python bool selects the branch on the host, which skips the unused update
entirely (the counterpart of XLA dead-code-eliminating a constant-False
gate); a tensor selects elementwise on the device without a host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet
from zhusuan_tpu_torch.profiling import _NO_SPAN, span
from zhusuan_tpu_torch.utils import merge_dicts

__all__ = [
    "make_log_joint_fn",
    "tree_normal_like",
    "tree_random_momentum",
    "tree_velocity",
    "kinetic_energy",
    "hamiltonian",
    "leapfrog_step",
    "leapfrog_trajectory",
    "leapfrog_trajectory_cached",
    "make_grad_fn",
    "get_acceptance_rate",
    "get_acceptance_rate_cached",
    "hmc_transition",
    "dual_averaging_update",
    "ewmv_update",
    "run_driver",
]

Latent = Dict[str, torch.Tensor]


def make_log_joint_fn(meta_bn_or_log_joint, observed):
    """Build ``log_posterior(latent_dict) -> chain-shaped tensor`` from a
    :class:`~zhusuan_tpu_torch.framework.MetaBayesianNet` or a raw
    ``log_joint(obs_dict)`` callable (parity: reference hmc.py:412-416,
    sgmcmc.py:121-133)."""
    if isinstance(meta_bn_or_log_joint, MetaBayesianNet):
        def log_joint(obs):
            return meta_bn_or_log_joint.observe(**obs).log_joint()
    elif callable(meta_bn_or_log_joint):
        log_joint = meta_bn_or_log_joint
    else:
        raise TypeError(
            "Expected a MetaBayesianNet or a callable log-joint function, "
            "got {!r}.".format(type(meta_bn_or_log_joint)))

    def log_posterior(latent: Latent):
        return log_joint(merge_dicts(latent, observed))

    return log_posterior


def _select(cond, a, b):
    """``cond ? a : b`` for a Python bool (host branch) or a bool tensor."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def tree_normal_like(generator, like: Latent, eps: Latent = None) -> Latent:
    """Standard normals shaped like each latent of ``like`` and in its
    dtype, drawn from ``generator`` (a ``torch.Generator`` on the latents'
    device), one draw per name in sorted-name order (the order of
    ``zhusuan_tpu/mcmc/base.py::tree_normal_like``); ``eps`` replaces them
    exactly (a testing hook for feeding both packages the same noise)."""
    out = {}
    for name in sorted(like):
        x = like[name]
        if eps is not None:
            out[name] = eps[name].to(x.dtype)
        else:
            out[name] = torch.randn(x.shape, generator=generator,
                                    dtype=x.dtype, device=x.device)
    return out


def tree_random_momentum(generator, q: Latent, mass: Latent,
                         eps: Latent = None) -> Latent:
    """p[name] = N(0, 1) draw * sqrt(mass[name]) (reference hmc.py:21-23),
    the draws of :func:`tree_normal_like`."""
    return {name: e * torch.sqrt(mass[name])
            for name, e in tree_normal_like(generator, q, eps).items()}


def tree_velocity(p: Latent, mass: Latent) -> Latent:
    """v = p / m (reference hmc.py:26-27)."""
    return {k: p[k] / mass[k] for k in p}


def dual_averaging_update(
    da_step, h_bar, log_eps_bar, step_size, mean_acceptance, gate,
    fresh_start, *, mu, target, gamma, t0, kappa,
):
    """One Nesterov dual-averaging step-size update (Hoffman & Gelman
    2014; reference hmc.py:89-112). Elementwise over the tuner state.

    :param gate: update when True; when False return the dual-averaged
        ``exp(log_eps_bar)`` (or the current step size if adaptation never
        ran) and hold the accumulators.
    :param fresh_start: restart the accumulators this step.
    :return: ``(step_size, da_step, h_bar, log_eps_bar)``.
    """
    frozen = torch.where(da_step > 0, torch.exp(log_eps_bar), step_size)
    if gate is False:
        return frozen, da_step, h_bar, log_eps_bar
    # Pin to the tuner-state dtype: a wider-dtype acceptance statistic must
    # not promote the adaptation state (fault class of mcmc/base.py:123-127
    # in the JAX package).
    mean_acceptance = torch.as_tensor(mean_acceptance).to(step_size.dtype)
    if isinstance(fresh_start, bool):
        fs = 1.0 if fresh_start else 0.0
    else:
        fs = fresh_start.to(step_size.dtype)
    new_step = (1.0 - fs) * da_step + 1.0
    rate1 = 1.0 / (new_step + t0)
    new_h_bar = (1.0 - fs) * (1.0 - rate1) * h_bar + rate1 * (
        target - mean_acceptance
    )
    log_eps = mu - torch.sqrt(new_step) / gamma * new_h_bar
    pow_ = torch.pow(new_step, -kappa)
    new_log_eps_bar = (
        pow_ * log_eps + (1.0 - fs) * (1.0 - pow_) * log_eps_bar
    )
    return (
        _select(gate, torch.exp(log_eps), frozen),
        _select(gate, new_step, da_step),
        _select(gate, new_h_bar, h_bar),
        _select(gate, new_log_eps_bar, log_eps_bar),
    )


def adapt_span(name: str, gate):
    """The span of one adaptation step (``zs.adapt.<what>``): a
    :func:`~zhusuan_tpu_torch.profiling.span` while ``gate`` is on (a
    tensor gate counts as on), nothing once it is the Python False, when
    the step only hands back the frozen value."""
    return _NO_SPAN if gate is False else span(name)


def ewmv_update(q, ewmv_t, ewmv_mean, ewmv_var, gate, n_chain_dims, decay):
    """One EW moving-variance accumulator update over the chain axes
    (reference hmc.py:115-159), gated by ``gate``.

    :return: ``(new_t, new_mean, new_var)``, held when ``gate`` is False.
    """
    if gate is False:
        return ewmv_t, ewmv_mean, ewmv_var
    chain_axes = tuple(range(n_chain_dims))
    if isinstance(gate, bool):
        new_t = ewmv_t + 1.0
    else:
        new_t = ewmv_t + gate.to(ewmv_t.dtype)
    safe_t = torch.clamp(new_t, min=1.0)
    weight = (1.0 - decay) / (1.0 - torch.pow(decay, safe_t))
    new_mean, new_var = {}, {}
    for k, x in q.items():
        incr = weight * (x - ewmv_mean[k])
        mean_k = ewmv_mean[k] + _mean(incr, chain_axes)
        var_k = (1.0 - weight) * ewmv_var[k] + _mean(
            incr * (x - mean_k), chain_axes)
        new_mean[k] = _select(gate, mean_k, ewmv_mean[k])
        new_var[k] = _select(gate, var_k, ewmv_var[k])
    return new_t, new_mean, new_var


def run_driver(one, pick, state, n_iters: int, collect: bool,
               thinning: int):
    """Run loop shared by the Metropolis-family, slice, discrete-Gibbs and
    Gibbs samplers (the port of ``scan_run_driver``, JAX
    ``mcmc/base.py:244``): ``n_iters`` calls of ``one(state, i) -> (state,
    info)`` in a Python loop, stacking ``pick(info)`` (a dict of tensors or
    of dicts of tensors) every ``thinning``-th iteration into preallocated
    iteration-major buffers. The draws of an iteration depend on the key
    and the iteration only, so the output IS the full trajectory sliced
    ``thinning-1::thinning`` and the final state is the unthinned run's.
    Each call of ``one`` is a ``zs.iter`` span and each store a
    ``zs.collect`` span (:func:`~zhusuan_tpu_torch.profiling.span`).

    :return: ``(final_state, outs or None)``; ``outs`` has ``n_iters //
        thinning`` rows.
    """
    if int(thinning) < 1:
        raise ValueError("thinning must be >= 1.")
    thinning, n_iters = int(thinning), int(n_iters)
    n_out = n_iters // thinning if collect else 0
    outs = {} if collect else None

    def store(row, picked):
        for f, v in picked.items():
            if isinstance(v, dict):
                buf = outs.setdefault(f, {})
                for n, x in v.items():
                    if n not in buf:
                        buf[n] = x.new_empty((n_out,) + tuple(x.shape))
                    buf[n][row].copy_(x)
            else:
                v = torch.as_tensor(v)
                if f not in outs:
                    outs[f] = v.new_empty((n_out,) + tuple(v.shape))
                outs[f][row].copy_(v)

    for i in range(n_iters):
        with span("zs.iter"):
            state, info = one(state, i)
        row, hit = divmod(i + 1, thinning)
        if collect and hit == 0 and row <= n_out:
            with span("zs.collect"):
                store(row - 1, pick(info))
    return state, outs


def _mean(x, axes):
    return torch.mean(x, dim=axes, keepdim=True) if axes else x


def _sum_data(x, n_chain_dims):
    axes = tuple(range(n_chain_dims, x.ndim))
    # torch.sum over an empty dim tuple would reduce every axis.
    return torch.sum(x, dim=axes) if axes else x


def kinetic_energy(q: Latent, p: Latent, mass: Latent,
                   n_chain_dims: int) -> torch.Tensor:
    """0.5 * sum p^2/m over data axes (reference hmc.py:30-35),
    chain-shaped. ``q`` only supplies the latent names."""
    kinetic = None
    for k in q:
        term = 0.5 * _sum_data(torch.square(p[k]) / mass[k], n_chain_dims)
        kinetic = term if kinetic is None else kinetic + term
    return kinetic


def hamiltonian(
    q: Latent,
    p: Latent,
    log_posterior: Callable[[Latent], torch.Tensor],
    mass: Latent,
    n_chain_dims: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """H = -log_post(q) + 0.5 * sum p^2/m over data axes
    (reference hmc.py:30-35). Returns ``(H, log_post)``, chain-shaped.
    """
    log_p = log_posterior(q)
    return -log_p + kinetic_energy(q, p, mass, n_chain_dims), log_p


def leapfrog_step(q, p, step_size1, step_size2, grad_fn, mass):
    """One generalized leapfrog sub-step: drift by ``step_size1``, then kick
    by ``step_size2`` (reference hmc.py:38-43)."""
    v = tree_velocity(p, mass)
    q = {k: q[k] + step_size1 * v[k] for k in q}
    grads = grad_fn(q)
    p = {k: p[k] + step_size2 * grads[k] for k in p}
    return q, p


def make_grad_fn(log_posterior):
    """``grad_fn(latent) -> {name: d sum(log_posterior) / d latent[name]}``
    by autograd: chains are independent, so the gradient of the summed
    log-posterior is every chain's own gradient in one pass."""

    def grad_fn(q: Latent) -> Latent:
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in q.items()}
            total = torch.sum(log_posterior(leaves))
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        return {k: (g if g is not None else torch.zeros_like(leaves[k]))
                for k, g in zip(leaves, grads)}

    return grad_fn


def leapfrog_trajectory(q, p, step_size, n_leapfrogs: int, grad_fn, mass):
    """``n_leapfrogs + 1`` boundary-aware sub-steps (reference
    hmc.py:347-372): the drift is skipped on the first sub-step and the
    kick is halved on the first and the last."""
    zero = torch.zeros_like(step_size)
    for i in range(n_leapfrogs + 1):
        ss1 = step_size if i > 0 else zero
        ss2 = step_size if 0 < i < n_leapfrogs else step_size / 2
        q, p = leapfrog_step(q, p, ss1, ss2, grad_fn, mass)
    return q, p


def leapfrog_trajectory_cached(q, p, step_size, n_leapfrogs: int, grad_fn,
                               mass, g0):
    """The trajectory of :func:`leapfrog_trajectory` with the gradient at
    ``q`` supplied (``g0``) and the end point's gradient returned:
    ``n_leapfrogs`` gradient evaluations instead of ``n_leapfrogs + 1``.
    Returns ``(q, p, grad)``."""
    p = {k: p[k] + (step_size / 2) * g0[k] for k in p}
    g = g0
    for i in range(1, n_leapfrogs + 1):
        v = tree_velocity(p, mass)
        q = {k: q[k] + step_size * v[k] for k in q}
        g = grad_fn(q)
        ss2 = step_size if i < n_leapfrogs else step_size / 2
        p = {k: p[k] + ss2 * g[k] for k in p}
    return q, p, g


def get_acceptance_rate(q, p, new_q, new_p, log_posterior, mass,
                        n_chain_dims):
    """MH acceptance with the non-finite -> reject guard (reference
    hmc.py:46-61). Returns ``(old_h, new_h, old_log_prob, new_log_prob,
    acceptance_rate)``, all chain-shaped."""
    old_h, old_log_prob = hamiltonian(q, p, log_posterior, mass,
                                      n_chain_dims)
    return _finish_acceptance(
        old_h, old_log_prob, new_q, new_p, log_posterior, mass, n_chain_dims
    )


def get_acceptance_rate_cached(q, p, new_q, new_p, log_posterior, mass,
                               n_chain_dims, old_log_prob):
    """:func:`get_acceptance_rate` with ``log_posterior(q)`` supplied by
    the caller (carried from the previous iteration)."""
    old_h = -old_log_prob + kinetic_energy(q, p, mass, n_chain_dims)
    return _finish_acceptance(
        old_h, old_log_prob, new_q, new_p, log_posterior, mass, n_chain_dims
    )


def _finish_acceptance(old_h, old_log_prob, new_q, new_p, log_posterior,
                       mass, n_chain_dims):
    new_h, new_log_prob = hamiltonian(new_q, new_p, log_posterior, mass,
                                      n_chain_dims)
    # torch.clamp keeps a NaN difference NaN, so the guard rejects it.
    acceptance_rate = torch.exp(torch.clamp(old_h - new_h, max=0.0))
    is_finite = torch.isfinite(acceptance_rate) & torch.isfinite(new_log_prob)
    acceptance_rate = torch.where(
        is_finite, acceptance_rate, torch.zeros_like(acceptance_rate)
    )
    return old_h, new_h, old_log_prob, new_log_prob, acceptance_rate


def hmc_transition(q, p, u, step_size, n_leapfrogs: int, grad_fn,
                   log_posterior, mass, n_chain_dims, old_log_prob=None,
                   g0=None, trajectory=None):
    """One HMC transition from drawn momentum ``p`` and MH uniforms ``u``
    (reference hmc.py:474-498): the boundary-aware trajectory, both
    Hamiltonians with the non-finite -> reject guard, and the per-chain MH
    select. The plain paths of ``HMC.sample`` and ``ChEESHMC.sample`` and
    the kernels' plain versions (``ops/hmc_step.py::
    fused_hmc_step_reference``, ``ops/chees_step.py::
    fused_chees_step_reference``) all run it.

    :param old_log_prob: ``log_posterior(q)`` when already known (the
        carried cache); evaluated here otherwise.
    :param g0: the gradient at ``q`` when carried; the trajectory then
        takes ``n_leapfrogs`` gradient evaluations and the kept point's
        gradient is returned.
    :param trajectory: optional ``(q, p, step_size, n_leapfrogs) ->
        (q', p')`` replacing :func:`leapfrog_trajectory` when ``g0`` is
        None (``HMC(experimental_fused_leapfrog=True)`` passes the
        trajectory kernel here).
    :return: ``(q', acceptance_rate, old_log_prob, log_prob, old_h, new_h,
        grad', prop_q, prop_p)``: ``q'``, ``log_prob`` and ``grad'`` are
        those of the kept point (``grad'`` is None unless ``g0`` was
        given); ``(prop_q, prop_p)`` is the trajectory's endpoint, kept or
        not.
    """
    if g0 is not None:
        prop_q, prop_p, prop_g = leapfrog_trajectory_cached(
            q, p, step_size, n_leapfrogs, grad_fn, mass, g0)
    elif trajectory is not None:
        prop_q, prop_p = trajectory(q, p, step_size, n_leapfrogs)
    else:
        prop_q, prop_p = leapfrog_trajectory(q, p, step_size, n_leapfrogs,
                                             grad_fn, mass)
    if old_log_prob is not None:
        old_h, new_h, old_log_prob, new_log_prob, acc = \
            get_acceptance_rate_cached(q, p, prop_q, prop_p, log_posterior,
                                       mass, n_chain_dims, old_log_prob)
    else:
        old_h, new_h, old_log_prob, new_log_prob, acc = get_acceptance_rate(
            q, p, prop_q, prop_p, log_posterior, mass, n_chain_dims)
    take = u.to(acc.dtype) < acc
    new_q, new_g = {}, ({} if g0 is not None else None)
    for k in q:
        cond = take.reshape(take.shape + (1,) * (q[k].ndim - take.ndim))
        new_q[k] = torch.where(cond, prop_q[k], q[k])
        if g0 is not None:
            new_g[k] = torch.where(cond, prop_g[k], g0[k])
    new_log_prob = torch.where(take, new_log_prob, old_log_prob)
    return (new_q, acc, old_log_prob, new_log_prob, old_h, new_h, new_g,
            prop_q, prop_p)
