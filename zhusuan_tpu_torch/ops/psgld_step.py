"""Fused PSGLD transition: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/psgld_step.py::
fused_psgld_step``: the RMSprop accumulator
``rms' = decay rms + (1 - decay) g^2``, the preconditioner
``G = 1 / (epsilon + sqrt(rms'))`` and the preconditioned Langevin step
``q' = q + 0.5 lr G g + sqrt(lr G) eps`` (Li et al. 2015, Eq. 4-5) in one
pass. The kernel is the PSGLD mode of ``csrc/sgmcmc_step.cu`` (see
:mod:`.sgld_step`): it reads q and rms once and writes q' and rms' once, so
at 32768 x 100 float32 its bound is device-memory bandwidth (52 MB at
3.35 TB/s, 15.6 us on an H100). Same built-in densities, random numbers
and ``noise=`` hook as :mod:`.sgld_step`.
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.ops._random import STREAM_SGMCMC_NOISE
from zhusuan_tpu_torch.ops.hmc_step import density_pointers, raise_on_error
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

__all__ = ["DENSITIES", "fused_psgld_step", "fused_psgld_step_reference",
           "psgld_step_supported"]

#: The shape and dtype rule of the kernel (the SGLD kernel's, as in the JAX
#: package).
psgld_step_supported = sgld_step_supported


def fused_psgld_step(density, q, rms, lr, decay: float, epsilon: float, key,
                     t: int, *, noise=None):
    """Run one PSGLD update for every chain.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_psgld_step_reference`.

    :param density: a built-in density of :data:`DENSITIES` over ``q``.
    :param q, rms: ``[n_chains, dim]`` positions and RMSprop accumulator
        (float32 on the card).
    :param lr: the learning rate: a number or a one-element tensor.
    :param decay, epsilon: the preconditioner's constants.
    :param key: Philox key ``(k0, k1)``; ``t``: iteration number.
    :param noise: optional ``[n_chains, dim]`` standard normals replacing
        the draws (testing hook).
    :return: ``(q', rms')``.
    """
    check_state("fused_psgld_step", density, q, rms=rms)
    check_normals(q, eps=noise)
    if q.device.type == "cpu":
        return fused_psgld_step_reference(density, q, rms, lr, decay,
                                          epsilon, key, t, noise=noise)
    check_launch("fused_psgld_step", q, rms)
    c, d = q.shape
    dev = q.device
    decay, epsilon = float(decay), float(epsilon)
    lr_ptr, lr_host, _lr_kept = lr_argument(lr, dev)
    _eps_kept, eps_ptr = noise_pointer(noise)
    out_q = torch.empty_like(q)
    out_rms = torch.empty_like(rms)
    lib, _ = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zs_fused_psgld_step(
            q.data_ptr(), rms.data_ptr(), *density_pointers(density, dev),
            lr_ptr, lr_host, decay, 1.0 - decay, epsilon, eps_ptr, c, d,
            *launch_key(key), int(t) & 0xFFFFFFFF, out_q.data_ptr(),
            out_rms.data_ptr(), stream)
    raise_on_error(rc, lib, "fused_psgld_step")
    fused_psgld_step.launches += 1
    return out_q, out_rms


fused_psgld_step.launches = 0


def fused_psgld_step_reference(density, q, rms, lr, decay: float,
                               epsilon: float, key, t: int, *, noise=None):
    """Plain torch version of :func:`fused_psgld_step`: the kernel's Philox
    draws (or the injected ``noise``), then the sampler's plain transition
    :func:`..mcmc.sgmcmc.psgld_transition`, in q's dtype."""
    from zhusuan_tpu_torch.mcmc import base, sgmcmc

    check_state("fused_psgld_step", density, q, rms=rms)
    check_normals(q, eps=noise)
    eps = normals(key, t, q, STREAM_SGMCMC_NOISE, noise)
    name = density.name
    grad_fn = base.make_grad_fn(base.make_log_joint_fn(density, {}))
    with torch.no_grad():
        new_q, new_rms = sgmcmc.psgld_transition(
            {name: q}, {name: rms},
            sgmcmc.learning_rate_tensor(lr, q.dtype, q.device), float(decay),
            float(epsilon), grad_fn, {name: eps})
    return new_q[name], new_rms[name]
