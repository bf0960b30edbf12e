"""Fused SGNHT transition (per-coordinate thermostat): a hand-written CUDA
kernel and its plain version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/sgnht_step.py::
fused_sgnht_step``: SGNHT (Ding et al. 2014, Alg. 2) with a thermostat per
chain and coordinate, first or second order, in one pass. The kernel is
the SGNHT mode of ``csrc/sgmcmc_step.cu`` (see :mod:`.sgld_step`): it reads
q, v and alpha once and writes q', v' and alpha' once, so at 32768 x 100
float32 its bound is device-memory bandwidth (79 MB at 3.35 TB/s, 23.5 us
on an H100). Only the vector thermostat is fused: the scalar one reduces
``mean(v^2)`` over every chain and dimension, which couples the chains,
and stays on the sampler's plain path, as in the JAX package. Momentum
resampling is decided by the caller, as in :mod:`.sghmc_step`.
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.ops._random import (
    STREAM_SGMCMC_NOISE,
    STREAM_SGMCMC_RESAMPLE,
)
from zhusuan_tpu_torch.ops.hmc_step import density_pointers, raise_on_error
from zhusuan_tpu_torch.ops.sghmc_step import split_noise
from zhusuan_tpu_torch.ops.sgld_step import (
    DENSITIES,
    check_launch,
    check_normals,
    check_state,
    kernel_library,
    launch_key,
    lr_argument,
    noise_pointer,
    normals,
    sgld_step_supported,
)

__all__ = ["DENSITIES", "fused_sgnht_step", "fused_sgnht_step_reference",
           "sgnht_step_supported"]

#: The shape and dtype rule of the kernel (the SGLD kernel's, as in the JAX
#: package).
sgnht_step_supported = sgld_step_supported


def fused_sgnht_step(density, q, v, alpha, lr, a: float, tune_rate: float,
                     second_order: bool, key, t: int, *,
                     resample: bool = False, noise=None):
    """Run one SGNHT update with a per-coordinate thermostat for every
    chain.

    First order: ``v' = (1 - alpha) v + lr g(q) + noise; q' = q + v';
    alpha' = alpha + tune_rate (v'^2 - lr)``, noise ``sqrt(2 a lr) eps``.
    Second order: a half-step thermostat update, ``exp(-alpha1/2)`` decays
    around the mid-point gradient, then the second half step.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_sgnht_step_reference`.

    :param density: a built-in density of :data:`DENSITIES` over ``q``.
    :param q, v, alpha: ``[n_chains, dim]`` position, momentum and
        thermostat (float32 on the card).
    :param lr: the learning rate: a number or a one-element tensor.
    :param a: the injected-noise constant (``variance_extra``).
    :param tune_rate: the thermostat's rate.
    :param key: Philox key ``(k0, k1)``; ``t``: iteration number.
    :param resample: replace v by ``sqrt(lr) N(0, 1)`` first.
    :param noise: optional ``(eps, eps_v)`` as for
        :func:`.sghmc_step.fused_sghmc_step`.
    :return: ``(q', v', alpha')``.
    """
    check_state("fused_sgnht_step", density, q, v=v, alpha=alpha)
    eps, eps_v = split_noise(noise, resample)
    check_normals(q, eps=eps, eps_v=eps_v)
    if q.device.type == "cpu":
        return fused_sgnht_step_reference(
            density, q, v, alpha, lr, a, tune_rate, second_order, key, t,
            resample=resample, noise=noise)
    check_launch("fused_sgnht_step", q, v, alpha)
    c, d = q.shape
    dev = q.device
    a, tune_rate = float(a), float(tune_rate)
    lr_ptr, lr_host, _lr_kept = lr_argument(lr, dev)
    _eps_kept, eps_ptr = noise_pointer(eps)
    _epsv_kept, eps_v_ptr = noise_pointer(eps_v)
    out_q = torch.empty_like(q)
    out_v = torch.empty_like(v)
    out_alpha = torch.empty_like(alpha)
    lib, _ = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zs_fused_sgnht_step(
            q.data_ptr(), v.data_ptr(), alpha.data_ptr(),
            *density_pointers(density, dev), lr_ptr, lr_host, 2 * a,
            tune_rate, 0.5 * tune_rate, int(bool(second_order)),
            int(bool(resample)), eps_ptr, eps_v_ptr, c, d, *launch_key(key),
            int(t) & 0xFFFFFFFF, out_q.data_ptr(), out_v.data_ptr(),
            out_alpha.data_ptr(), stream)
    raise_on_error(rc, lib, "fused_sgnht_step")
    fused_sgnht_step.launches += 1
    return out_q, out_v, out_alpha


fused_sgnht_step.launches = 0


def fused_sgnht_step_reference(density, q, v, alpha, lr, a: float,
                               tune_rate: float, second_order: bool, key,
                               t: int, *, resample: bool = False, noise=None):
    """Plain torch version of :func:`fused_sgnht_step`: the kernel's Philox
    draws (or the injected ``noise``), the resample when asked, then the
    sampler's plain transition :func:`..mcmc.sgmcmc.sgnht_transition` with
    the vector thermostat, in q's dtype."""
    from zhusuan_tpu_torch.mcmc import base, sgmcmc

    check_state("fused_sgnht_step", density, q, v=v, alpha=alpha)
    eps, eps_v = split_noise(noise, resample)
    check_normals(q, eps=eps, eps_v=eps_v)
    name = density.name
    lr_t = sgmcmc.learning_rate_tensor(lr, q.dtype, q.device)
    grad_fn = base.make_grad_fn(base.make_log_joint_fn(density, {}))
    with torch.no_grad():
        if resample:
            v = sgmcmc.resample_momentum(
                lr_t, {name: normals(key, t, q, STREAM_SGMCMC_RESAMPLE,
                                     eps_v)}, {name: v})[name]
        new_q, new_v, new_alpha, _ = sgmcmc.sgnht_transition(
            {name: q}, {name: v}, {name: alpha}, lr_t, float(a),
            float(tune_rate), bool(second_order), True, grad_fn,
            {name: normals(key, t, q, STREAM_SGMCMC_NOISE, eps)})
    return new_q[name], new_v[name], new_alpha[name]
