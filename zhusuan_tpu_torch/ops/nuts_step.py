"""Fused NUTS transition: a hand-written CUDA kernel and its plain version.

Replaces both Pallas TPU kernels of ``zhusuan_tpu/ops/nuts_step.py``:
``fused_nuts_transition`` (the whole tree fully unrolled, depth <= 6) and
``fused_nuts_transition_looped`` (depths 7-12, leaves under an early-exit
loop). The unrolled/looped split is a TPU artefact: Mosaic compiles the
unrolled tree fastest but its size grows as ``2**depth``. One CUDA kernel
(``csrc/nuts_step.cu``, CUDA C++ for ``sm_90a``) serves every depth from
1 to 12: each chain is a group of ``L`` lanes that runs its own tree, and a
warp's ``32 / L`` chains step their leaves together until the last of them
stops. ``L`` follows from the width (:func:`nuts_lanes`), and
:func:`nuts_layout` chooses where the checkpoint stacks live (shared
memory, or a global scratch buffer that stays in L2) from the shape alone.

The kernel computes the built-in densities of :data:`DENSITIES`, whose
parameters it reads through pointers: the diagonal Gaussian over one
latent, and four posteriors over several latents with the data they hold
(:class:`~zhusuan_tpu_torch.ops.densities.LatentDictDensity`: eight schools
centred and non-centred, ordinal regression, Weibull AFT survival, and the
LKJ covariance model, which holds its data as one scatter matrix), which
the sampler ravels into one row a chain in sorted-name order. For those the
kernel carries the edges' gradients (one density evaluation a leaf) and
takes the C entry ``zs_fused_nuts_transition_data``; the diagonal Gaussian
keeps ``zs_fused_nuts_transition``. Any other log-joint takes the
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
import functools

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import (
    STREAM_MOMENTUM,
    STREAM_NUTS_DIRECTION,
    STREAM_NUTS_LEAF,
    STREAM_NUTS_MERGE,
    philox_normal,
    philox_uniform_rows,
)
from zhusuan_tpu_torch.ops.densities import (
    CovarianceEstimationLogJoint,
    DiagonalGaussianLogJoint,
    EightSchoolsLogJoint,
    LatentDictDensity,
    OrderedLogisticRegressionLogJoint,
    WeibullAFTLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import check_density

__all__ = [
    "DENSITIES",
    "MAX_DIM",
    "MAX_TREE_DEPTH",
    "fused_nuts_transition",
    "fused_nuts_transition_reference",
    "kernel_library",
    "nuts_data_lanes",
    "nuts_lanes",
    "nuts_layout",
    "nuts_noise",
    "nuts_resident_chains",
    "nuts_shared_bytes",
    "nuts_step_supported",
]

# One lane holds up to 4 groups of 4 elements (csrc/nuts_step.cu dispatch),
# so a chain on L lanes takes dim <= 16 L, and 32 lanes take 512.
MAX_DIM = 512
# An H100 (sm_90): its SMs, the shared memory of one SM and of one block
# (the kernel's launch is refused above it), the runtime's share of each
# resident block, and resident blocks per SM.
H100_SMS = 132
SM_SHARED_BYTES = 233472
BLOCK_SHARED_BYTES = 232448
BLOCK_RESERVED_BYTES = 1024
MAX_BLOCKS_PER_SM = 32
# The checkpoint stacks of a depth-12 tree at dim 512 still fit one warp's
# shared memory (csrc/nuts_step.cu); the JAX package's looped kernel has the
# same cap.
MAX_TREE_DEPTH = 12
# A built-in with data takes 32 lanes a chain above this many data rows, 8
# up to it (csrc/nuts_step.cu's launch_data).
DATA_ROWS_FOR_32_LANES = 32
#: The built-in densities the NUTS kernel evaluates.
DENSITIES = (DiagonalGaussianLogJoint, EightSchoolsLogJoint,
             OrderedLogisticRegressionLogJoint, WeibullAFTLogJoint,
             CovarianceEstimationLogJoint)


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


def nuts_lanes(dim: int) -> int:
    """Lanes a chain at ``dim``: ``csrc/nuts_step.cu``'s dispatch, the
    narrowest of 8, 16 and 32 lanes that hold the row in at most 4 groups of
    4 elements a lane (the chain's scalar work is then shared by the most
    chains). At 4096 x 100 on an H100, 8 lanes beat 16 and 32 at depths 6, 8
    and 10 (PERF_APPENDIX.md)."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError("the kernel takes 1 <= dim <= {}; got {}.".format(
            MAX_DIM, dim))
    return 8 if dim <= 128 else 16 if dim <= 256 else 32


def nuts_data_lanes(n_rows: int) -> int:
    """Lanes a chain of a built-in with data (:class:`LatentDictDensity`,
    rows of at most 16 elements on its first 4 lanes), which split its
    ``n_rows`` data rows: ``csrc/nuts_step.cu``'s ``launch_data``."""
    return 32 if int(n_rows) > DATA_ROWS_FOR_32_LANES else 8


def _lanes(dim, data_rows):
    return nuts_lanes(dim) if data_rows is None else nuts_data_lanes(
        data_rows)


def _slots(max_tree_depth: int) -> int:
    return max(1, int(max_tree_depth) - 1)


def nuts_shared_bytes(dim: int, max_tree_depth: int,
                      stacks_in_shared: bool, data_rows=None) -> int:
    """Dynamic shared memory of one block (one warp, ``32 / lanes``
    chains): ``csrc/nuts_step.cu``'s rule. A chain keeps the far edge
    ``(q, p)`` (and its gradient, for a built-in with ``data_rows`` data
    rows, whose gradient the kernel carries), the tree's proposal and, when
    ``stacks_in_shared``, its two checkpoint stacks of ``max(D - 1, 1)``
    rows each; a row is ``ceil(dim / 4)`` float4s."""
    rows = ((3 if data_rows is None else 4)
            + (2 * _slots(max_tree_depth) if stacks_in_shared else 0))
    return (32 // _lanes(dim, data_rows)) * rows * (-(-dim // 4)) * 16


def nuts_resident_chains(dim: int, max_tree_depth: int,
                         stacks_in_shared: bool, data_rows=None) -> int:
    """Chains that shared memory lets one H100 SM hold at once (registers
    may allow fewer; ``-Xptxas -v`` reports them). 0 when one block does not
    fit at all."""
    need = nuts_shared_bytes(dim, max_tree_depth, stacks_in_shared,
                             data_rows)
    if need > BLOCK_SHARED_BYTES:
        return 0
    blocks = min(MAX_BLOCKS_PER_SM,
                 SM_SHARED_BYTES // (need + BLOCK_RESERVED_BYTES))
    return blocks * (32 // _lanes(dim, data_rows))


@functools.lru_cache(maxsize=None)
def nuts_layout(dim: int, max_tree_depth: int, n_chains: int,
                data_rows=None):
    """``(lanes, stacks_in_shared)`` of the kernel for this shape: the
    chain's width (:func:`nuts_lanes`), and the checkpoint stacks in shared
    memory when every chain is then resident on the card at once, else in
    global memory (L2). Set from measurements on an H100
    (PERF_APPENDIX.md): at 4096 x 100 shared stacks won at depths 6 and 8
    (all chains resident either way) and lost 1.5x at depth 10, where they
    hold 3168 of the 4096 chains and the rest wait. ``data_rows``: those of
    a built-in with data (its lanes by :func:`nuts_data_lanes`, one more
    shared row a chain), None for the diagonal Gaussian."""
    resident = H100_SMS * nuts_resident_chains(dim, max_tree_depth, True,
                                               data_rows)
    return _lanes(dim, data_rows), n_chains <= resident


def kernel_library():
    """Build (at first use) and load the kernel's shared library; returns
    ``(cdll, build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("nuts_step")
    if not getattr(lib, "_zs_typed", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.zs_fused_nuts_transition.argtypes = (
            [ptr] * 9 + [i32, i32, i32, ctypes.c_float, u32, u32, u32]
            + [ptr] * 10)
        lib.zs_fused_nuts_transition.restype = i32
        lib.zs_fused_nuts_transition_data.argtypes = (
            [i32, ptr, ptr, i32] + [ptr] * 7
            + [i32, i32, i32, ctypes.c_float, u32, u32, u32] + [ptr] * 10)
        lib.zs_fused_nuts_transition_data.restype = i32
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

    :param density: one of :data:`DENSITIES` over ``q`` (for a
        :class:`LatentDictDensity`, its latents raveled in sorted-name
        order).
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
    data_rows = (density.n_rows if isinstance(density, LatentDictDensity)
                 else None)
    return _launch(density, q, inv_mass, step_size, max_tree_depth,
                   max_delta_energy, key, t, noise,
                   nuts_layout(q.shape[1], max_tree_depth, q.shape[0],
                               data_rows)[1])


def _launch(density, q, inv_mass, step_size, max_tree_depth,
            max_delta_energy, key, t, noise, stacks_in_shared):
    """Launch the kernel on tensors that passed :func:`_check_inputs`, with
    the checkpoint stacks in shared memory or not:
    :func:`fused_nuts_transition` passes :func:`nuts_layout`'s choice, the
    tests and measurements either. Counted on
    :func:`fused_nuts_transition`."""
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
    carried = isinstance(density, LatentDictDensity)
    if carried and density.kernel_ineligible() is not None:
        raise ValueError("the CUDA kernel cannot evaluate this {}: {}.".format(
            type(density).__name__, density.kernel_ineligible()))
    if stacks_in_shared and (nuts_shared_bytes(
            d, max_tree_depth, True, density.n_rows if carried else None)
            > BLOCK_SHARED_BYTES):
        raise ValueError(
            "the checkpoint stacks of depth {} at dim {} do not fit one "
            "block's shared memory.".format(max_tree_depth, d))
    dev = q.device
    p0, p1 = density.kernel_args(dev)
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
    stacks = None
    if not stacks_in_shared:
        # A row for every chain slot of the last block (at most 3 spare).
        stacks = torch.empty(
            ((c + 3) * 2 * _slots(max_tree_depth) * (-(-d // 4)) * 4,),
            dtype=torch.float32, device=dev)
    out_q = torch.empty_like(q)
    lp, h, acc = (torch.empty((c,), dtype=torch.float32, device=dev)
                  for _ in range(3))
    depth, n_leap = (torch.empty((c,), dtype=torch.int32, device=dev)
                     for _ in range(2))
    turning, divergent = (torch.empty((c,), dtype=torch.bool, device=dev)
                          for _ in range(2))
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    rest = (ss.data_ptr(), *noise_ptrs, c, d, int(max_tree_depth),
            float(max_delta_energy), k0, k1, int(t) & 0xFFFFFFFF,
            None if stacks is None else stacks.data_ptr(),
            out_q.data_ptr(), lp.data_ptr(), h.data_ptr(), acc.data_ptr(),
            depth.data_ptr(), n_leap.data_ptr(), turning.data_ptr(),
            divergent.data_ptr())
    outs = (out_q, lp, h, acc, depth, n_leap, turning, divergent)
    io = dict(inputs=(q, inv_mass, p0, p1, ss, *(noise or ())),
              outputs=outs)
    if carried:
        launch_kernel(
            fused_nuts_transition, kernel_library,
            "zs_fused_nuts_transition_data", dev, density.kernel_id,
            p0.data_ptr(), p1.data_ptr(), density.n_rows, q.data_ptr(),
            inv_mass.data_ptr(), *rest, **io)
    else:
        launch_kernel(
            fused_nuts_transition, kernel_library,
            "zs_fused_nuts_transition", dev, q.data_ptr(),
            inv_mass.data_ptr(), p0.data_ptr(), p1.data_ptr(), *rest, **io)
    return outs


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
