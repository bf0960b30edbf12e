"""Fused SGLD transition: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/sgld_step.py::
fused_sgld_step``: the whole Langevin update ``q' = q + 0.5 lr g(q) +
sqrt(lr) eps`` (noise draw, gradient, position update) in one pass over
the state. The kernel reads q once and writes q' once, so at the main
path's 32768 x 100 float32 its bound is device-memory bandwidth (26 MB at
3.35 TB/s, 7.8 us on an H100). :func:`sgld_layout` names its body in
``csrc/sgmcmc_step.cu``: on the diagonal density at ``dim % 4 == 0`` (the
main path) the update is elementwise, so a flat pass takes ``[n_chains,
dim]`` as groups of 4 elements, a thread a group, with 16-byte loads and
stores (:func:`sgld_flat_groups` is its index map); anything else takes the
SGLD mode of the SGMCMC kernel body (a warp per chain, as the HMC kernels).
The same library holds the PSGLD, SGHMC and SGNHT modes
(:mod:`.psgld_step`, :mod:`.sghmc_step`, :mod:`.sgnht_step`), which share
this module's checks and loader.

The Pallas kernel traces any user gradient into its body. A CUDA kernel
cannot, so the kernel computes the gradients of the built-in densities of
:mod:`.densities` named in :data:`DENSITIES`; any other log-joint takes the
sampler's plain path.

Random numbers: Philox4x32-10 written into the kernel (``csrc/philox.cuh``),
keyed by a pair of ints and counted by (iteration, chain, group of 4
elements, :data:`._random.STREAM_SGMCMC_NOISE`). The plain version draws
the same numbers in torch. ``noise=eps`` replaces the draws exactly in both;
it is a testing hook, not a user feature.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import STREAM_SGMCMC_NOISE, philox_normal
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import (
    MAX_DIM,
    check_density,
    check_device,
    density_pointers,
    hmc_step_supported,
)

__all__ = ["DENSITIES", "fused_sgld_step", "fused_sgld_step_reference",
           "sgld_flat_groups", "sgld_layout", "sgld_step_supported"]

#: The built-in densities the SGMCMC kernels take the gradient of.
DENSITIES = (DiagonalGaussianLogJoint, EquicorrelatedGaussianLogJoint)


def sgld_step_supported(q_shape, dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA kernel takes a ``[n_chains, dim]`` state of this
    shape (and dtype, when given: float32 only). The shape rule is the HMC
    kernel's, as in the JAX package; the PSGLD, SGHMC and SGNHT kernels
    share it."""
    return hmc_step_supported(q_shape) and dtype in (None, torch.float32)


def sgld_layout(density, dim: int) -> str:
    """The SGLD kernel's body for ``density`` at ``dim``: ``"flat"`` (a
    thread a group of 4 elements, 16-byte loads and stores) where the
    gradient is elementwise and the row splits into whole groups, i.e. the
    diagonal density at ``dim % 4 == 0``; else ``"warp"`` (a warp a chain,
    the body PSGLD, SGHMC and SGNHT share)."""
    if isinstance(density, DiagonalGaussianLogJoint) and dim % 4 == 0:
        return "flat"
    return "warp"


def sgld_flat_groups(n_chains: int, dim: int, device=None):
    """The flat body's index map: for flat group ``i`` of ``[n_chains,
    dim / 4]`` (elements ``4 i .. 4 i + 3`` of the flattened state), its
    ``(chain, group)`` as two int64 tensors, ``(i // (dim / 4),
    i % (dim / 4))``, the Philox counter words the kernel draws it with."""
    row_groups = dim // 4
    i = torch.arange(n_chains * row_groups, dtype=torch.int64, device=device)
    return i // row_groups, i % row_groups


def _aligned(*tensors) -> bool:
    return all(v is None or v.data_ptr() % 16 == 0 for v in tensors)


def kernel_library():
    """Build (at first use) and load the SGMCMC kernels' shared library;
    returns ``(cdll, build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("sgmcmc_step")
    if not getattr(lib, "_zs_typed", False):
        ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_float)
        dens = [i32, ptr, ptr]  # density id, dens0, dens1
        lr = [ptr, f32]  # lr_dev, lr_host
        tail = [i32, i32, u32, u32, u32]  # n_chains, dim, key0, key1, t
        lib.zs_fused_sgld_step.argtypes = (
            [ptr] + dens + lr + [ptr] + tail + [i32, ptr, ptr])
        lib.zs_fused_psgld_step.argtypes = (
            [ptr, ptr] + dens + lr + [f32] * 3 + [ptr] + tail + [ptr] * 3)
        lib.zs_fused_sghmc_step.argtypes = (
            [ptr, ptr] + dens + lr + [f32] * 3 + [i32, i32, ptr, ptr] + tail
            + [ptr] * 4)
        lib.zs_fused_sgnht_step.argtypes = (
            [ptr, ptr, ptr] + dens + lr + [f32] * 3 + [i32, i32, ptr, ptr]
            + tail + [ptr] * 4)
        for fn in (lib.zs_fused_sgld_step, lib.zs_fused_psgld_step,
                   lib.zs_fused_sghmc_step, lib.zs_fused_sgnht_step):
            fn.restype = i32
        lib.zs_cuda_error_string.argtypes = [i32]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def check_state(fn_name, density, q, **others):
    """Raise unless ``q`` is ``[n_chains, dim]`` under one of the built-in
    :data:`DENSITIES` and every other tensor (None skipped) has q's shape
    and device."""
    if q.ndim != 2:
        raise ValueError(
            "q must be [n_chains, dim]; got shape {}.".format(tuple(q.shape)))
    check_density(fn_name, density, DENSITIES, q.shape[1])
    given = [(name, v) for name, v in others.items() if v is not None]
    for name, v in given:
        if v.shape != q.shape:
            raise ValueError("{} must be {}; got {}.".format(
                name, list(q.shape), list(v.shape)))
    check_device(q, *given)


def check_launch(fn_name, q, *others):
    """Raise unless ``q`` and the other (not None) state tensors are float32
    and contiguous at a shape the kernel takes."""
    tensors = [q] + [v for v in others if v is not None]
    if any(v.dtype != torch.float32 for v in tensors):
        raise TypeError("{} takes float32 tensors on the card; got {}."
                        .format(fn_name, [str(v.dtype) for v in tensors]))
    if not sgld_step_supported(q.shape, q.dtype):
        raise ValueError("{} takes 1 <= dim <= {}; got shape {}.".format(
            fn_name, MAX_DIM, tuple(q.shape)))
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("{}'s state tensors must be contiguous.".format(
            fn_name))


def lr_argument(lr, dev):
    """``(lr_dev pointer or None, lr_host, kept tensor)`` for the kernel: a
    number, or a one-element tensor on the host, goes by value; a
    one-element CUDA tensor goes as a float32 pointer on ``dev`` (no host
    sync either way)."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError("the learning rate must be a number or a "
                             "one-element tensor; got shape {}.".format(
                                 tuple(lr.shape)))
        if lr.device.type != "cuda":
            return None, float(lr), None
        kept = lr.to(device=dev, dtype=torch.float32).reshape(1)
        return kept.data_ptr(), 0.0, kept
    return None, float(lr), None


def normals(key, t: int, q, stream: int, injected=None):
    """The ``[n_chains, dim]`` standard normals of one kernel stream (the
    kernel's Philox draws), or ``injected`` as given."""
    if injected is not None:
        return injected
    return philox_normal(key, t, q.shape, stream, q.device)


def check_normals(q, **given):
    """Raise unless each given normals tensor (None skipped) is shaped and
    placed like ``q``."""
    for name, v in given.items():
        if v is None:
            continue
        if tuple(v.shape) != tuple(q.shape):
            raise ValueError("noise {} must be {}; got {}.".format(
                name, list(q.shape), list(v.shape)))
        if v.device != q.device:
            raise ValueError("noise must be on q's device {}.".format(
                q.device))


def noise_pointer(eps):
    """A float32 contiguous copy of ``eps`` and its pointer, or
    ``(None, None)``."""
    if eps is None:
        return None, None
    kept = eps.to(torch.float32).contiguous()
    return kept, kept.data_ptr()


def launch_key(key):
    """The key's two words as uint32 ints (``(0, 0)`` when None: the
    kernel then reads only injected normals)."""
    if key is None:
        return 0, 0
    return tuple(int(k) & 0xFFFFFFFF for k in key)


def fused_sgld_step(density, q, lr, key, t: int, *, noise=None,
                    _path=None):
    """Run one SGLD update ``q + 0.5 lr grad(q) + sqrt(lr) eps`` for every
    chain.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_sgld_step_reference`.

    :param density: a built-in density of :data:`DENSITIES` over ``q``.
    :param q: ``[n_chains, dim]`` positions (float32 on the card).
    :param lr: the learning rate: a number or a one-element tensor.
    :param key: Philox key ``(k0, k1)`` (see :func:`._random.philox_key`).
    :param t: iteration number, the first word of the Philox counter.
    :param noise: optional ``[n_chains, dim]`` standard normals replacing
        the draws (testing hook).
    :param _path: ``"warp"`` to take the warp-per-chain body where
        :func:`sgld_layout` says ``"flat"`` (measurements and tests compare
        the two).
    :return: ``q'``.
    """
    check_state("fused_sgld_step", density, q)
    check_normals(q, eps=noise)
    if q.device.type == "cpu":
        return fused_sgld_step_reference(density, q, lr, key, t, noise=noise)
    check_launch("fused_sgld_step", q)
    c, d = q.shape
    dev = q.device
    lr_ptr, lr_host, _lr_kept = lr_argument(lr, dev)
    eps_kept, eps_ptr = noise_pointer(noise)
    out_q = torch.empty_like(q)
    dens_id, dens0, dens1 = density_pointers(density, dev)
    # The flat body reads 16 bytes at a time: a view that starts off a
    # 16-byte boundary takes the warp body.
    flat = (sgld_layout(density, d) == "flat" and _path != "warp"
            and _aligned(q, eps_kept, *density.kernel_args(dev)))
    launch_kernel(
        fused_sgld_step, kernel_library, "zs_fused_sgld_step", dev,
        q.data_ptr(), dens_id, dens0, dens1, lr_ptr, lr_host, eps_ptr, c, d,
        *launch_key(key), int(t) & 0xFFFFFFFF, int(flat), out_q.data_ptr(),
        inputs=(q, *density.kernel_args(dev), _lr_kept, eps_kept),
        outputs=(out_q,))
    return out_q


fused_sgld_step.launches = 0


def fused_sgld_step_reference(density, q, lr, key, t: int, *, noise=None):
    """Plain torch version of :func:`fused_sgld_step`: the kernel's Philox
    draws (or the injected ``noise``), then the sampler's plain transition
    :func:`..mcmc.sgmcmc.sgld_transition` (autograd gradient), in q's
    dtype."""
    from zhusuan_tpu_torch.mcmc import base, sgmcmc

    check_state("fused_sgld_step", density, q)
    check_normals(q, eps=noise)
    eps = normals(key, t, q, STREAM_SGMCMC_NOISE, noise)
    name = density.name
    grad_fn = base.make_grad_fn(base.make_log_joint_fn(density, {}))
    with torch.no_grad():
        new_q = sgmcmc.sgld_transition(
            {name: q}, sgmcmc.learning_rate_tensor(lr, q.dtype, q.device),
            grad_fn, {name: eps})
    return new_q[name]
