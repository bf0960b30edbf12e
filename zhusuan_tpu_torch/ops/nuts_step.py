"""Fused NUTS transition: a hand-written CUDA kernel and its plain version.

Replaces both Pallas TPU kernels of ``zhusuan_tpu/ops/nuts_step.py``:
``fused_nuts_transition`` (the whole tree fully unrolled, depth <= 6) and
``fused_nuts_transition_looped`` (depths 7-12, leaves under an early-exit
loop). The unrolled/looped split is a TPU artefact: Mosaic compiles the
unrolled tree fastest but its size grows as ``2**depth``. One CUDA kernel
(``csrc/nuts_step.cu``, CUDA C++ for ``sm_90a``) serves every depth from
1 to 12: each chain is one warp that runs its own tree and stops when its
chain stops, where the Pallas kernels mask every chain of a block in
lock-step to its slowest chain.

The kernel computes one built-in density (:data:`DENSITIES`),
:class:`~zhusuan_tpu_torch.ops.densities.DiagonalGaussianLogJoint`, whose
parameters it reads through pointers; any other log-joint takes the
sampler's plain path.

Random numbers: the momentum from the HMC kernel's Philox stream
(``STREAM_MOMENTUM``), the direction, leaf and merge uniforms from three
streams of their own (``STREAM_NUTS_*``), keyed once per run and counted by
(iteration, chain, group of 4, stream) (:mod:`._random`). The plain
version draws the same numbers in torch; ``noise=(eps, u_dir, u_leaf,
u_merge)`` replaces the draws exactly in both (a testing hook).

Outputs match the TPU kernels: ``(q' [c, d], log_prob [c], energy [c],
accept_stat [c], depth [c] int32, n_leapfrogs [c] int32, turning [c] bool,
divergent [c] bool)``.
"""

from __future__ import annotations

import ctypes

import torch

from zhusuan_tpu_torch.ops._random import (
    STREAM_MOMENTUM,
    STREAM_NUTS_DIRECTION,
    STREAM_NUTS_LEAF,
    STREAM_NUTS_MERGE,
    philox_normal,
    philox_uniform_rows,
)
from zhusuan_tpu_torch.ops.densities import DiagonalGaussianLogJoint
from zhusuan_tpu_torch.ops.hmc_step import check_density

__all__ = [
    "DENSITIES",
    "MAX_DIM",
    "MAX_TREE_DEPTH",
    "fused_nuts_transition",
    "fused_nuts_transition_reference",
    "kernel_library",
    "nuts_noise",
    "nuts_step_supported",
]

# One lane holds up to 4 groups of 4 elements (csrc/nuts_step.cu dispatch).
MAX_DIM = 512
# The checkpoint stacks of a depth-12 tree at dim 512 still fit one warp's
# shared memory (csrc/nuts_step.cu); the JAX package's looped kernel has the
# same cap.
MAX_TREE_DEPTH = 12
#: The built-in densities the NUTS kernel evaluates.
DENSITIES = (DiagonalGaussianLogJoint,)


def nuts_step_supported(q_shape, max_tree_depth: int,
                        dtype=None) -> bool:
    """Whether the CUDA kernel takes a ``[n_chains, dim]`` state of this
    shape at this depth (and dtype, when given)."""
    if len(q_shape) != 2:
        return False
    if not 1 <= int(max_tree_depth) <= MAX_TREE_DEPTH:
        return False
    c, d = q_shape
    if not (1 <= c < 2 ** 31 and 1 <= d <= MAX_DIM):
        return False
    return dtype is None or dtype == torch.float32


def kernel_library():
    """Build (at first use) and load the kernel's shared library; returns
    ``(cdll, build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("nuts_step")
    if not getattr(lib, "_zs_typed", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.zs_fused_nuts_transition.argtypes = (
            [ptr] * 9 + [i32, i32, i32, ctypes.c_float, u32, u32, u32]
            + [ptr] * 9)
        lib.zs_fused_nuts_transition.restype = i32
        lib.zs_cuda_error_string.argtypes = [i32]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def nuts_noise(key, t: int, n_chains: int, dim: int, max_tree_depth: int,
               device=None):
    """The kernel's own draws for iteration ``t``: ``(eps [c, dim],
    u_dir [c, D], u_leaf [c, 2**D - 1], u_merge [c, D])``, float32."""
    D = int(max_tree_depth)
    return (
        philox_normal(key, t, (n_chains, dim), STREAM_MOMENTUM, device),
        philox_uniform_rows(key, t, (n_chains, D), STREAM_NUTS_DIRECTION,
                            device),
        philox_uniform_rows(key, t, (n_chains, (1 << D) - 1),
                            STREAM_NUTS_LEAF, device),
        philox_uniform_rows(key, t, (n_chains, D), STREAM_NUTS_MERGE,
                            device),
    )


def _check_inputs(density, q, inv_mass, max_tree_depth, noise):
    if q.ndim != 2:
        raise ValueError(
            "q must be [n_chains, dim]; got shape {}.".format(tuple(q.shape)))
    c, d = q.shape
    check_density("fused_nuts_transition", density, DENSITIES, d)
    if tuple(inv_mass.shape) != (1, d):
        raise ValueError("inv_mass must be [1, {}]; got {}.".format(
            d, tuple(inv_mass.shape)))
    if int(max_tree_depth) < 1:
        raise ValueError("max_tree_depth must be >= 1.")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("q must be on the CPU or a CUDA device; got "
                         "{}.".format(q.device))
    if inv_mass.device != q.device:
        raise ValueError("inv_mass is on {}, q on {}.".format(
            inv_mass.device, q.device))
    if noise is not None:
        D = int(max_tree_depth)
        want = [(c, d), (c, D), (c, (1 << D) - 1), (c, D)]
        got = [tuple(v.shape) for v in noise]
        if got != want:
            raise ValueError(
                "noise must be (eps, u_dir, u_leaf, u_merge) of shapes {}; "
                "got {}.".format(want, got))
        if any(v.device != q.device for v in noise):
            raise ValueError("noise must be on q's device {}.".format(
                q.device))


def fused_nuts_transition(density, q, inv_mass, step_size,
                          max_tree_depth: int, max_delta_energy: float, key,
                          t: int, *, noise=None):
    """Run one full NUTS transition for every chain.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_nuts_transition_reference`.

    :param density: a :class:`DiagonalGaussianLogJoint` over ``q``.
    :param q: ``[n_chains, dim]`` positions (float32 on the card).
    :param inv_mass: ``[1, dim]`` inverse diagonal mass (float32 on the
        card).
    :param step_size: scalar tensor on q's device, or a float.
    :param max_tree_depth: doublings per iteration, 1 to 12 on the card.
    :param max_delta_energy: divergence threshold on ``H - H0``.
    :param key: Philox key ``(k0, k1)`` (see :func:`._random.philox_key`).
    :param t: iteration number, the first word of the Philox counter.
    :param noise: optional ``(eps, u_dir, u_leaf, u_merge)`` replacing the
        draws (testing hook; layout of :func:`..mcmc.nuts.nuts_transition`).
    :return: ``(q', log_prob, energy, accept_stat, depth, n_leapfrogs,
        turning, divergent)``.
    """
    _check_inputs(density, q, inv_mass, max_tree_depth, noise)
    if q.device.type == "cpu":
        return fused_nuts_transition_reference(
            density, q, inv_mass, step_size, max_tree_depth,
            max_delta_energy, key, t, noise=noise)
    if q.dtype != torch.float32 or inv_mass.dtype != torch.float32:
        raise TypeError(
            "the CUDA kernel takes float32 q and inv_mass; got {} and "
            "{}.".format(q.dtype, inv_mass.dtype))
    if not nuts_step_supported(q.shape, max_tree_depth, q.dtype):
        raise ValueError(
            "the CUDA kernel takes 1 <= dim <= {} and 1 <= max_tree_depth "
            "<= {}; got shape {} and depth {}.".format(
                MAX_DIM, MAX_TREE_DEPTH, tuple(q.shape), max_tree_depth))
    if not (q.is_contiguous() and inv_mass.is_contiguous()):
        raise ValueError("q and inv_mass must be contiguous.")
    c, d = q.shape
    dev = q.device
    loc, inv_var = density.kernel_args(dev)
    if isinstance(step_size, torch.Tensor):
        ss = step_size.to(device=dev, dtype=torch.float32).reshape(1)
    else:
        ss = torch.full((1,), float(step_size), dtype=torch.float32,
                        device=dev)
    if noise is not None:
        noise = [v.to(torch.float32).contiguous() for v in noise]
        noise_ptrs = [v.data_ptr() for v in noise]
    else:
        noise_ptrs = [None] * 4
    out_q = torch.empty_like(q)
    lp, h, acc = (torch.empty((c,), dtype=torch.float32, device=dev)
                  for _ in range(3))
    depth, n_leap = (torch.empty((c,), dtype=torch.int32, device=dev)
                     for _ in range(2))
    turning, divergent = (torch.empty((c,), dtype=torch.bool, device=dev)
                          for _ in range(2))
    lib, _ = kernel_library()
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zs_fused_nuts_transition(
            q.data_ptr(), inv_mass.data_ptr(), loc.data_ptr(),
            inv_var.data_ptr(), ss.data_ptr(), *noise_ptrs, c, d,
            int(max_tree_depth), float(max_delta_energy), k0, k1,
            int(t) & 0xFFFFFFFF, out_q.data_ptr(), lp.data_ptr(),
            h.data_ptr(), acc.data_ptr(), depth.data_ptr(),
            n_leap.data_ptr(), turning.data_ptr(), divergent.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(
            "fused_nuts_transition launch failed: CUDA error {} ({})."
            .format(rc, lib.zs_cuda_error_string(rc).decode()))
    fused_nuts_transition.launches += 1
    return out_q, lp, h, acc, depth, n_leap, turning, divergent


fused_nuts_transition.launches = 0


def fused_nuts_transition_reference(density, q, inv_mass, step_size,
                                    max_tree_depth: int,
                                    max_delta_energy: float, key, t: int, *,
                                    noise=None):
    """Plain torch version of :func:`fused_nuts_transition`: the kernel's
    Philox draws (:func:`nuts_noise`, or the injected ``noise``), then the
    sampler's plain transition :func:`..mcmc.nuts.nuts_transition`
    (autograd gradient), in ``q``'s dtype."""
    from zhusuan_tpu_torch.mcmc.nuts import nuts_transition, value_and_grad

    _check_inputs(density, q, inv_mass, max_tree_depth, noise)
    if noise is None:
        noise = nuts_noise(key, t, q.shape[0], q.shape[1], max_tree_depth,
                           q.device)
    with torch.no_grad():
        return nuts_transition(
            value_and_grad(density.log_prob), q, inv_mass.reshape(-1),
            step_size, max_tree_depth, max_delta_energy, noise)
