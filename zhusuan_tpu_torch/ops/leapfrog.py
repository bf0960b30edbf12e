"""Fused leapfrog trajectory: a hand-written CUDA kernel and its plain
version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/leapfrog.py::
fused_leapfrog``: the boundary-aware trajectory of ``n_leapfrogs + 1``
sub-steps (drift skipped on the first, kick halved on the first and the
last; reference hmc.py:347-372) from a given momentum, with no momentum
draw and no MH test. ``HMC(experimental_fused_leapfrog=True)`` routes its
trajectory here when the whole-step kernel is not taken.

The kernel is the trajectory mode of the HMC-family kernel body in
``csrc/hmc_step.cu`` (a warp per chain, the state in registers for the
whole trajectory): it reads q, p and the mass once and writes q' and p'
once, so it is bound by the per-warp instruction chain of the gradient
evaluations, not by device-memory bandwidth. It evaluates the built-in
densities of :data:`DENSITIES`; the Pallas kernel traced any closure.
"""

from __future__ import annotations

from typing import Optional

import torch

from zhusuan_tpu_torch.ops.hmc_step import (
    DENSITIES,
    MAX_DIM,
    check_density,
    check_device,
    density_pointers,
    device_scalar,
    hmc_step_supported,
    kernel_library,
    raise_on_error,
)

__all__ = ["DENSITIES", "fused_leapfrog", "fused_leapfrog_reference",
           "leapfrog_supported"]


def leapfrog_supported(q_shape, dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA kernel takes a ``[n_chains, dim]`` state of this
    shape (and dtype, when given: float32 only)."""
    return hmc_step_supported(q_shape) and dtype in (None, torch.float32)


def _check_inputs(density, q, p, mass):
    if q.ndim != 2:
        raise ValueError(
            "q must be [n_chains, dim]; got shape {}.".format(tuple(q.shape)))
    c, d = q.shape
    check_density("fused_leapfrog", density, DENSITIES, d)
    if tuple(p.shape) != (c, d):
        raise ValueError("p must be [{}, {}]; got {}.".format(
            c, d, tuple(p.shape)))
    if tuple(mass.shape) not in ((1, d), (c, d)):
        raise ValueError("mass must be [1, {0}] or [{1}, {0}]; got {2}."
                         .format(d, c, tuple(mass.shape)))
    check_device(q, ("p", p), ("mass", mass))


def fused_leapfrog(density, q, p, step_size, n_leapfrogs: int, mass):
    """Run the boundary-aware trajectory for every chain.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_leapfrog_reference`.

    :param density: a built-in density of :data:`DENSITIES` over ``q``.
    :param q, p: ``[n_chains, dim]`` position and momentum (float32 on the
        card).
    :param step_size: scalar tensor on q's device, or a float.
    :param n_leapfrogs: leapfrog steps (``n_leapfrogs + 1`` sub-steps), a
        host int as in the JAX package.
    :param mass: ``[1, dim]`` or ``[n_chains, dim]`` diagonal mass.
    :return: ``(q', p')``.
    """
    _check_inputs(density, q, p, mass)
    if q.device.type == "cpu":
        return fused_leapfrog_reference(density, q, p, step_size,
                                        n_leapfrogs, mass)
    if not all(v.dtype == torch.float32 for v in (q, p, mass)):
        raise TypeError("the CUDA kernel takes float32 q, p and mass; got "
                        "{}, {} and {}.".format(q.dtype, p.dtype, mass.dtype))
    if not leapfrog_supported(q.shape, q.dtype):
        raise ValueError("the CUDA kernel takes 1 <= dim <= {}; got shape "
                         "{}.".format(MAX_DIM, tuple(q.shape)))
    if not all(v.is_contiguous() for v in (q, p, mass)):
        raise ValueError("q, p and mass must be contiguous.")
    if int(n_leapfrogs) < 0:
        raise ValueError("n_leapfrogs must be >= 0.")
    c, d = q.shape
    dev = q.device
    ss = device_scalar(step_size, dev)
    out_q = torch.empty_like(q)
    out_p = torch.empty_like(p)
    lib, _ = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zs_fused_leapfrog(
            q.data_ptr(), p.data_ptr(), mass.data_ptr(),
            int(mass.shape[0] != 1),
            *density_pointers(density, dev), ss.data_ptr(), c, d,
            int(n_leapfrogs), out_q.data_ptr(), out_p.data_ptr(), stream)
    raise_on_error(rc, lib, "fused_leapfrog")
    fused_leapfrog.launches += 1
    return out_q, out_p


fused_leapfrog.launches = 0


def fused_leapfrog_reference(density, q, p, step_size, n_leapfrogs: int,
                             mass):
    """Plain torch version of :func:`fused_leapfrog`: the sampler's plain
    trajectory :func:`..mcmc.base.leapfrog_trajectory` (autograd
    gradient), in q's dtype."""
    from zhusuan_tpu_torch.mcmc import base

    _check_inputs(density, q, p, mass)
    name = density.name
    grad_fn = base.make_grad_fn(base.make_log_joint_fn(density, {}))
    with torch.no_grad():
        nq, np_ = base.leapfrog_trajectory(
            {name: q}, {name: p},
            torch.as_tensor(step_size, dtype=q.dtype, device=q.device),
            int(n_leapfrogs), grad_fn, {name: mass})
    return nq[name], np_[name]
