"""Fused SGHMC transition: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/sghmc_step.py::
fused_sghmc_step``: the first- or second-order SGHMC integrator (Chen et
al. 2014, Eq. 15; Chen et al. 2015) with friction ``alpha`` and noise
``sqrt(max(2 (alpha - beta) lr, 0)) eps``, and the per-chain sum of
``v'^2`` for the ``mean_k`` statistic, in one pass. The kernel is the
SGHMC mode of ``csrc/sgmcmc_step.cu`` (see :mod:`.sgld_step`): it reads q
and v once and writes q', v' and one float per chain, so at 32768 x 100
float32 its bound is device-memory bandwidth (52.6 MB at 3.35 TB/s,
15.7 us on an H100). The per-chain sum is accumulated in float64 on both
sides, so kernel and plain version agree bit for bit.

Momentum resampling (every ``n_iter_resample_v`` iterations) is decided by
the caller on the host, outside the kernel, as in the JAX package; with
``resample=True`` the kernel replaces v by ``sqrt(lr) N(0, 1)`` drawn from
its own Philox stream (:data:`._random.STREAM_SGMCMC_RESAMPLE`) before the
integrator, in the same pass.
"""

from __future__ import annotations

import math

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import (
    STREAM_SGMCMC_NOISE,
    STREAM_SGMCMC_RESAMPLE,
)
from zhusuan_tpu_torch.ops.hmc_step import density_pointers
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

__all__ = ["DENSITIES", "fused_sghmc_step", "fused_sghmc_step_reference",
           "sghmc_step_supported", "split_noise"]

#: The shape and dtype rule of the kernel (the SGLD kernel's, as in the JAX
#: package).
sghmc_step_supported = sgld_step_supported


def split_noise(noise, resample: bool):
    """``(eps, eps_v)`` of a ``noise`` argument: None, or a pair of
    integrator normals and resample normals (None unless resampling)."""
    if noise is None:
        return None, None
    eps, eps_v = noise
    if resample and eps_v is None:
        raise ValueError("noise must hold the resample normals on an "
                         "iteration that resamples the momentum.")
    return eps, (eps_v if resample else None)


def fused_sghmc_step(density, q, v, lr, alpha: float, beta: float,
                     second_order: bool, key, t: int, *,
                     resample: bool = False, noise=None):
    """Run one SGHMC update for every chain.

    First order: ``v' = (1 - alpha) v + lr g(q) + noise; q' = q + v'``.
    Second order: ``q1 = q + v/2; v' = e (e v + lr g(q1) + noise);
    q' = q1 + v'/2`` with ``e = exp(-alpha/2)``.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_sghmc_step_reference`.

    :param density: a built-in density of :data:`DENSITIES` over ``q``.
    :param q, v: ``[n_chains, dim]`` position and momentum (float32 on the
        card).
    :param lr: the learning rate: a number or a one-element tensor.
    :param alpha, beta: friction and variance estimate.
    :param key: Philox key ``(k0, k1)``; ``t``: iteration number.
    :param resample: replace v by ``sqrt(lr) N(0, 1)`` first.
    :param noise: optional ``(eps, eps_v)``: ``[n_chains, dim]`` standard
        normals replacing the integrator draws and, when resampling, the
        resample draws (testing hook).
    :return: ``(q', v', sum_d v'^2 [n_chains])``.
    """
    check_state("fused_sghmc_step", density, q, v=v)
    eps, eps_v = split_noise(noise, resample)
    check_normals(q, eps=eps, eps_v=eps_v)
    if q.device.type == "cpu":
        return fused_sghmc_step_reference(
            density, q, v, lr, alpha, beta, second_order, key, t,
            resample=resample, noise=noise)
    check_launch("fused_sghmc_step", q, v)
    c, d = q.shape
    dev = q.device
    alpha, beta = float(alpha), float(beta)
    lr_ptr, lr_host, _lr_kept = lr_argument(lr, dev)
    _eps_kept, eps_ptr = noise_pointer(eps)
    _epsv_kept, eps_v_ptr = noise_pointer(eps_v)
    out_q = torch.empty_like(q)
    out_v = torch.empty_like(v)
    out_vsq = torch.empty((c,), dtype=torch.float32, device=dev)
    launch_kernel(
        fused_sghmc_step, kernel_library, "zs_fused_sghmc_step", dev,
        q.data_ptr(), v.data_ptr(), *density_pointers(density, dev),
        lr_ptr, lr_host, 2 * (alpha - beta), 1 - alpha,
        math.exp(-0.5 * alpha), int(bool(second_order)),
        int(bool(resample)), eps_ptr, eps_v_ptr, c, d, *launch_key(key),
        int(t) & 0xFFFFFFFF, out_q.data_ptr(), out_v.data_ptr(),
        out_vsq.data_ptr(),
        inputs=(q, v, *density.kernel_args(dev), _lr_kept, _eps_kept,
                _epsv_kept),
        outputs=(out_q, out_v, out_vsq))
    return out_q, out_v, out_vsq


fused_sghmc_step.launches = 0


def fused_sghmc_step_reference(density, q, v, lr, alpha: float, beta: float,
                               second_order: bool, key, t: int, *,
                               resample: bool = False, noise=None):
    """Plain torch version of :func:`fused_sghmc_step`: the kernel's Philox
    draws (or the injected ``noise``), the resample
    (:func:`..mcmc.sgmcmc.resample_momentum`) when asked, then the
    sampler's plain transition :func:`..mcmc.sgmcmc.sghmc_transition`, in
    q's dtype; the per-chain sums of ``v'^2`` accumulate in float64."""
    from zhusuan_tpu_torch.mcmc import base, sgmcmc

    check_state("fused_sghmc_step", density, q, v=v)
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
        new_q, new_v = sgmcmc.sghmc_transition(
            {name: q}, {name: v}, lr_t, float(alpha), float(beta),
            bool(second_order), grad_fn,
            {name: normals(key, t, q, STREAM_SGMCMC_NOISE, eps)})
    nv = new_v[name]
    vsq = torch.sum(nv * nv, -1, dtype=torch.float64).to(nv.dtype)
    return new_q[name], nv, vsq
