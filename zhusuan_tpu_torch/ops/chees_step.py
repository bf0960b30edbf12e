"""Fused ChEES-HMC transition: a hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/chees_step.py::
fused_chees_step``: the fused HMC transition of :mod:`.hmc_step` with two
changes. The leapfrog count is a device int32 scalar (ChEES jitters it
every iteration, and the sampler computes it on the device), so the
launch never waits for it; and the kernel also writes the proposal
endpoint ``(q', p')`` whether or not it is accepted, which the ChEES
criterion's gradient needs (``mcmc/chees.py::ChEESHMC._chees_grad``).

The kernel is the ChEES mode of the HMC-family kernel body in
``csrc/hmc_step.cu``: a warp per chain, the state in registers, the
momentum and MH uniform from K1's Philox streams (``STREAM_MOMENTUM``,
``STREAM_MH``, counter word ``t``), the K1 boundary schedule with ``n``
read on the device. It evaluates ``log p(q)`` itself, as the TPU kernel
does: for the closed-form built-ins that is one row sum against a
trajectory of up to ``max_leapfrogs`` gradients. float32 only, as the TPU
gate (``mcmc/chees.py:259-263``).

Outputs: ``(accepted_q, prop_q, prop_p, accept_prob, old_log_prob,
sel_log_prob)``; a divergent chain may write inf or NaN into ``prop_q``
and ``prop_p``, as the TPU kernel does.
"""

from __future__ import annotations

from typing import Optional

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import (
    STREAM_MH,
    STREAM_MOMENTUM,
    philox_normal,
    philox_uniform,
)
from zhusuan_tpu_torch.ops.hmc_step import (
    DENSITIES,
    MAX_DIM,
    check_density,
    check_device,
    check_noise,
    density_pointers,
    device_scalar,
    hmc_step_supported,
    kernel_library,
    noise_pointers,
)

__all__ = ["DENSITIES", "chees_step_supported", "fused_chees_step",
           "fused_chees_step_reference"]


def chees_step_supported(q_shape, dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA kernel takes a ``[n_chains, dim]`` state of this
    shape (and dtype, when given: float32 only)."""
    return hmc_step_supported(q_shape) and dtype in (None, torch.float32)


def _check_inputs(density, q, mass, n_steps, noise):
    if q.ndim != 2:
        raise ValueError(
            "q must be [n_chains, dim]; got shape {}.".format(tuple(q.shape)))
    c, d = q.shape
    check_density("fused_chees_step", density, DENSITIES, d)
    if tuple(mass.shape) != (1, d):
        raise ValueError("mass must be [1, {}]; got {}.".format(
            d, tuple(mass.shape)))
    if not isinstance(n_steps, torch.Tensor) or n_steps.numel() != 1:
        raise TypeError("n_steps must be a one-element int32 tensor.")
    check_device(q, ("mass", mass), ("n_steps", n_steps))
    check_noise(noise, q)


def fused_chees_step(density, q, mass, step_size, n_steps, key, t: int, *,
                     noise=None):
    """Run one jittered-length HMC transition for every chain.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_chees_step_reference`.

    :param density: a built-in density of :data:`DENSITIES` over ``q``.
    :param q: ``[n_chains, dim]`` float32 positions.
    :param mass: ``[1, dim]`` float32 diagonal mass.
    :param step_size: scalar tensor on q's device, or a float.
    :param n_steps: one-element int32 tensor on q's device: the leapfrog
        count shared by every chain (``n_steps + 1`` sub-steps).
    :param key: Philox key ``(k0, k1)`` (see :func:`._random.philox_key`).
    :param t: iteration number, the first word of the Philox counter.
    :param noise: optional ``(eps [c, d], u_mh [c])`` standard normals and
        uniforms replacing the draws (testing hook).
    :return: ``(accepted_q, prop_q, prop_p, accept_prob, old_log_prob,
        sel_log_prob)``.
    """
    _check_inputs(density, q, mass, n_steps, noise)
    if q.device.type == "cpu":
        return fused_chees_step_reference(density, q, mass, step_size,
                                          n_steps, key, t, noise=noise)
    if q.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32 q and mass; got {} "
                        "and {}.".format(q.dtype, mass.dtype))
    if n_steps.dtype != torch.int32:
        raise TypeError("n_steps must be int32; got {}.".format(
            n_steps.dtype))
    if not chees_step_supported(q.shape, q.dtype):
        raise ValueError("the CUDA kernel takes 1 <= dim <= {}; got shape "
                         "{}.".format(MAX_DIM, tuple(q.shape)))
    if not (q.is_contiguous() and mass.is_contiguous()):
        raise ValueError("q and mass must be contiguous.")
    c, d = q.shape
    dev = q.device
    ss = device_scalar(step_size, dev)
    _kept, (eps_ptr, u_ptr) = noise_pointers(noise)
    mats = [torch.empty((c, d), dtype=torch.float32, device=dev)
            for _ in range(3)]
    vecs = [torch.empty((c,), dtype=torch.float32, device=dev)
            for _ in range(3)]
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    launch_kernel(
        fused_chees_step, kernel_library, "zs_fused_chees_step", dev,
        q.data_ptr(), mass.data_ptr(), *density_pointers(density, dev),
        ss.data_ptr(), n_steps.data_ptr(), eps_ptr, u_ptr, c, d, k0, k1,
        int(t) & 0xFFFFFFFF, *[v.data_ptr() for v in mats + vecs],
        inputs=(q, mass, *density.kernel_args(dev), ss, *(_kept or ())),
        outputs=mats + vecs)
    return tuple(mats + vecs)


fused_chees_step.launches = 0


def fused_chees_step_reference(density, q, mass, step_size, n_steps, key,
                               t: int, *, noise=None):
    """Plain torch version of :func:`fused_chees_step`: the kernel's Philox
    draws (or the injected ``noise``), then the plain transition
    :func:`..mcmc.base.hmc_transition` (autograd gradient) in q's dtype.
    The leapfrog count is read to the host (one sync)."""
    from zhusuan_tpu_torch.mcmc import base

    _check_inputs(density, q, mass, n_steps, noise)
    if noise is None:
        eps = philox_normal(key, t, q.shape, STREAM_MOMENTUM, q.device)
        u = philox_uniform(key, t, (q.shape[0],), STREAM_MH, q.device)
    else:
        eps, u = noise
    name = density.name
    x0 = {name: q}
    m = {name: mass.to(q.dtype)}
    p0 = base.tree_random_momentum(None, x0, m, {name: eps})
    log_post = base.make_log_joint_fn(density, {})
    with torch.no_grad():
        (out_q, acc, old_lp, sel_lp, _, _, _, prop_q,
         prop_p) = base.hmc_transition(
            x0, p0, u, torch.as_tensor(step_size, dtype=q.dtype,
                                       device=q.device),
            int(n_steps), base.make_grad_fn(log_post), log_post, m, 1)
    return out_q[name], prop_q[name], prop_p[name], acc, old_lp, sel_lp
