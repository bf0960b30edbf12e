"""Whole-fit mean-field ADVI trainer: a hand-written CUDA kernel and its
plain version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/advi_step.py::
fused_meanfield_advi`` (``pallas_call`` at :270): the ENTIRE mean-field SGVB
optimisation in one launch. Per step the kernel (``csrc/advi_step.cu``, one
thread-block cluster whose blocks share out the particle rows and push
their partial sums into each other's shared memory, each waiting on a
transaction barrier for its inputs; a warp per particle row, or a lane per
row where ``dim <= 4``, as in the toy2d recipe; the layout from
:func:`advi_layout`) draws the particle noise, evaluates
the unconstrained log-posterior ``F`` and its z-gradient, forms the exact
pathwise ELBO gradient of the Gaussian's parameters

    d loss / d loc       = -mean(dF/dz)
    d loss / d log_scale = -mean(dF/dz * sigma * eps) - 1

(for a Gaussian scored at its own reparameterised sample the entropy term's
total derivative is exactly ``(0, 1)``: the JAX module's docstring derives
it), writes the loss estimate ``-mean F - 0.5 mean|eps|^2 - d 0.5 log(2 pi)
- sum(log_scale)`` (the value the plain ``sgvb`` loop reports) and applies an
Adam step in optax's form (``m / c1 / (sqrt(v / c2) + eps)``, bias
corrections ``1 - b^t``). Every block keeps a replica of the parameters
and Adam moments for the whole fit and updates it from the same totals in
the same order; the host sees one launch per fit.

Departures from the TPU kernel, each forced by the card:

- The Pallas body traces any user density. A CUDA kernel cannot, so the
  kernel evaluates the built-in densities named in :data:`DENSITIES`
  (``value_and_grad`` of :mod:`.densities`); any other model takes
  :func:`zhusuan_tpu_torch.variational.advi`'s plain loop.
- The schedule is a Python callable, which a kernel cannot call: the wrapper
  evaluates ``lr_t``, ``c1 = 1 - b1^(t+1)`` and ``c2 = 1 - b2^(t+1)`` on the
  host into one ``[n_steps, 3]`` float32 device tensor
  (:func:`schedule_table`), and the plain version reads the same table.
- The gate (:func:`advi_step_supported`) keeps the JAX gate's 1 MB particle
  block and ``n_steps <= 2^20`` and adds ``dim <= 512`` (a lane holds up to
  4 groups of 4 columns, as in the sampler kernels). The JAX gate's even
  particle count is gone: the TPU kernel fills row halves with the two
  Box-Muller outputs, this one puts both into one row. ``n_particles >= 1``
  (JAX: 2) follows.

Random numbers: Philox4x32-10 counted by ``(step, particle, group of 4
columns, STREAM_ADVI_NOISE)``; the plain version draws the same numbers in
torch. ``noise=`` (``[n_steps, n_particles, dim]``) replaces the draws in
both (a testing hook, as in the JAX package).

Every mean over particles is accumulated in float64 and rounded once on
both sides, so the kernel and :func:`fused_meanfield_advi_reference` agree
bit for bit while those sums are exact (float32 terms whose exponents span
less than ~20 bits), whatever the order of the reduction. Over thousands of
chained Adam steps a one-ulp difference (an inexact sum; ``exp`` of the
CPU's libm against the card's) grows, so whole fits are compared within a
tolerance.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import STREAM_ADVI_NOISE, philox_normal
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
    Toy2DLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import (
    MAX_DIM,
    check_density,
    density_pointers,
)

__all__ = ["DENSITIES", "advi_layout", "advi_rows", "advi_shared_bytes",
           "advi_step_supported", "advi_warps", "fused_meanfield_advi",
           "fused_meanfield_advi_reference", "schedule_table"]

#: The built-in densities the ADVI trainer's kernel evaluates.
DENSITIES = (DiagonalGaussianLogJoint, EquicorrelatedGaussianLogJoint,
             Toy2DLogJoint)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# The JAX gate's limits (zhusuan_tpu/ops/advi_step.py:73-75): one particle
# block of at most 1 MB, a loss trace of at most 2^20 steps.
_BLOCK_BYTES_LIMIT = 1 << 20
_MAX_STEPS = 1 << 20
# csrc/advi_step.cu's limits: blocks of a cluster (16 needs the
# non-portable cluster size), warps a block, a block's dynamic shared memory.
MAX_CLUSTER = 16
MAX_WARPS = 16
SHARED_BYTES_LIMIT = 232448 - 16  # less the two static transaction barriers


def advi_step_supported(dim: int, n_particles: int, n_steps: int,
                        itemsize: int = 4) -> bool:
    """Whether the kernel runs a fit of this size: ``1 <= dim <= 512``,
    ``1 <= n_steps <= 2^20``, at least one particle, and a particle block
    ``n_particles * dim * itemsize`` of at most 1 MB."""
    if dim < 1 or dim > MAX_DIM or n_steps < 1 or n_steps > _MAX_STEPS:
        return False
    if n_particles < 1:
        return False
    return n_particles * dim * itemsize <= _BLOCK_BYTES_LIMIT


def _lanes_quantities(dim: int) -> int:
    """Doubles a warp pushes a step at ``dim <= 4``: the 2 dim + 2 sums
    padded to a power of two (``csrc/advi_step.cu::Lanes::QP``)."""
    q = 2 * dim + 2
    return 4 if q <= 4 else 8 if q <= 8 else 16


def advi_shared_bytes(dim: int, cluster: int, warps: int) -> int:
    """A block's dynamic shared memory at this layout
    (``csrc/advi_step.cu``'s rule). ``dim <= 4``: the double-buffered slots
    of the cluster's ``cluster * warps`` partials. ``dim > 4``: the slots of
    ``cluster`` partials and the block's ``warps`` rows of ``2 (dim + 1)``
    doubles, then the replica (6 padded float vectors)."""
    if dim <= 4:
        return 8 * 2 * cluster * warps * _lanes_quantities(dim)
    padded = 128 * (1 if dim <= 128 else 2 if dim <= 256 else 4)
    return 8 * 2 * (dim + 1) * (2 * cluster + warps) + 4 * 6 * padded


def _layout_fits(dim: int, cluster: int, warps: int) -> bool:
    return (1 <= cluster <= MAX_CLUSTER and 1 <= warps <= MAX_WARPS
            and advi_shared_bytes(dim, cluster, warps) <= SHARED_BYTES_LIMIT)


# The layout rule's constants, from a sweep of every (cluster, warps) pair
# at nine (density, dim, particles) shapes on an H100 (PERF_APPENDIX.md;
# scripts/profile_advi_sgld.py --sweep). A unit is a particle row at a warp
# a row (dim > 4) or a tile of 32 rows at a lane a row (dim <= 4). Up to
# ONE_BLOCK_UNITS units one block wins (40 rows of toy2d: 1.157 us a step on
# one block of 2 warps, 1.24-1.26 on 2-4 blocks); past it, blocks of at most
# CLUSTER_WARPS warps, one unit a warp, over at least LANES_MIN_CLUSTER blocks
# at a lane a row (toy2d's 500 rows: 4 blocks of 4 warps 1.323 us, 2 of 8
# 1.417).
ONE_BLOCK_UNITS = 8
CLUSTER_WARPS = 8
LANES_MIN_CLUSTER = 4


@functools.lru_cache(maxsize=None)
def advi_layout(dim: int, n_particles: int):
    """``(cluster, warps, mode)`` of the kernel for one fit: the blocks of
    its cluster (1-16), the warps a block, and ``"lanes"`` (a lane per
    particle row, ``dim <= 4``) or ``"warps"`` (a warp per row).

    One block while :data:`ONE_BLOCK_UNITS` warps hold the rows, one row a
    lane or warp; else blocks of at most :data:`CLUSTER_WARPS` warps (over
    at least :data:`LANES_MIN_CLUSTER` blocks at a lane a row), as many as
    give each lane or warp one row, at most 16, fewer where a block's shared
    memory would not hold their partial sums. On an H100
    (PERF_APPENDIX.md), at the seven of the sweep's nine shapes where it
    timed the rule's own pair, that pair was the fastest or within 1% of
    it; at all nine the pairs around it beat the one-block kernel before
    this one."""
    if not 1 <= dim <= MAX_DIM or n_particles < 1:
        raise ValueError("advi_layout takes 1 <= dim <= {} and at least one "
                         "particle; got dim={}, n_particles={}.".format(
                             MAX_DIM, dim, n_particles))
    lanes = dim <= 4
    mode = "lanes" if lanes else "warps"
    units = -(-n_particles // 32) if lanes else n_particles
    if units <= ONE_BLOCK_UNITS:
        return 1, units, mode
    least = LANES_MIN_CLUSTER if lanes else 1
    cluster = min(MAX_CLUSTER, max(least, -(-units // CLUSTER_WARPS)))
    warps = min(CLUSTER_WARPS, -(-units // cluster))
    while cluster > 1 and not _layout_fits(dim, cluster, warps):
        cluster -= 1
    while not _layout_fits(dim, cluster, warps):
        warps -= 1
    return cluster, warps, mode


def advi_warps(dim: int, n_particles: int, cluster: int) -> int:
    """The warps a block takes when the cluster is forced to ``cluster``
    blocks (measurements and tests reach every cluster size with it): one
    a 32-row tile (``dim <= 4``) or a row, shared out over the blocks, at
    most 16, and as many as fit the block's shared memory."""
    units = -(-n_particles // 32) if dim <= 4 else n_particles
    warps = max(1, min(MAX_WARPS, -(-units // cluster)))
    while warps > 1 and not _layout_fits(dim, cluster, warps):
        warps -= 1
    return warps


def advi_rows(dim: int, n_particles: int, cluster: int, warps: int):
    """The particle rows each warp of the layout evaluates, in the kernel's
    order: ``rows[block][warp]`` is a list of row indices (a lane's rows
    when ``dim <= 4`` are the warp's rows ``32 k + lane``). Mirrors
    ``csrc/advi_step.cu``: at ``dim <= 4`` warp ``p = block * warps + warp``
    takes the 32-row tiles ``p, p + P, ...`` (``P = cluster * warps``); at
    ``dim > 4`` it takes rows ``p, p + P, ...``."""
    n_prod = cluster * warps
    out = []
    for block in range(cluster):
        per_warp = []
        for warp in range(warps):
            p = block * warps + warp
            if dim <= 4:
                rows = [r for tile in range(p, -(-n_particles // 32), n_prod)
                        for r in range(32 * tile,
                                       min(32 * tile + 32, n_particles))]
            else:
                rows = list(range(p, n_particles, n_prod))
            per_warp.append(rows)
        out.append(per_warp)
    return out


def _f32(v) -> float:
    return float(np.float32(v))


def schedule_table(lr_schedule: Callable, n_steps: int, b1: float, b2: float,
                   device=None) -> torch.Tensor:
    """The ``[n_steps, 3]`` float32 table ``(lr_t, 1 - b1^(t+1),
    1 - b2^(t+1))`` on ``device``: the schedule called on the host with the
    0-based step as a float, the powers in float32 arithmetic (as the JAX
    kernel computes them, ``advi_step.py:233-236``)."""
    n_steps = int(n_steps)
    table = np.empty((n_steps, 3), np.float32)
    table[:, 0] = [float(lr_schedule(float(t))) for t in range(n_steps)]
    tf = np.arange(1, n_steps + 1, dtype=np.float32)
    table[:, 1] = np.float32(1.0) - np.power(np.float32(b1), tf)
    table[:, 2] = np.float32(1.0) - np.power(np.float32(b2), tf)
    return torch.as_tensor(table, device=device)


def kernel_library():
    """Build (at first use) and load ``csrc/advi_step.cu``; returns
    ``(cdll, build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("advi_step")
    if not getattr(lib, "_zs_typed", False):
        ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_float)
        lib.zs_fused_meanfield_advi.argtypes = (
            [i32] + [ptr] * 6 + [i32] * 5 + [f32] * 6 + [u32] * 2 + [ptr] * 4)
        lib.zs_fused_meanfield_advi.restype = i32
        lib.zs_cuda_error_string.argtypes = [i32]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def _check(density, loc0, log_scale0, n_steps, n_particles, noise):
    """Validate the arguments; returns ``(dim, n_steps, n_particles)``."""
    if loc0.ndim != 1 or log_scale0.shape != loc0.shape:
        raise ValueError(
            "loc0 and log_scale0 must be 1-D tensors of one shape; got {} "
            "and {}.".format(tuple(loc0.shape), tuple(log_scale0.shape)))
    dim = loc0.shape[0]
    check_density("fused_meanfield_advi", density, DENSITIES, dim)
    if loc0.device.type not in ("cpu", "cuda"):
        raise ValueError("loc0 must be on the CPU or a CUDA device; got "
                         "{}.".format(loc0.device))
    if log_scale0.device != loc0.device:
        raise ValueError("log_scale0 is on {}, loc0 on {}.".format(
            log_scale0.device, loc0.device))
    n_steps, n_particles = int(n_steps), int(n_particles)
    if not advi_step_supported(dim, n_particles, n_steps):
        raise ValueError(
            "fused_meanfield_advi: unsupported size (dim={}, n_particles={}, "
            "n_steps={}); it takes dim <= {}, n_steps <= {} and a particle "
            "block of at most {} bytes.".format(
                dim, n_particles, n_steps, MAX_DIM, _MAX_STEPS,
                _BLOCK_BYTES_LIMIT))
    if noise is not None:
        if tuple(noise.shape) != (n_steps, n_particles, dim):
            raise ValueError(
                "noise must have shape [n_steps, n_particles, dim] = {}, "
                "got {}.".format((n_steps, n_particles, dim),
                                 tuple(noise.shape)))
        if noise.device != loc0.device:
            raise ValueError("noise must be on loc0's device {}.".format(
                loc0.device))
    return dim, n_steps, n_particles


def _adam_constants(b1, b2, adam_eps, dim, rounded=True):
    """``(b1, 1 - b1, b2, 1 - b2, adam_eps, dim * 0.5 log(2 pi))`` as Python
    floats, rounded to float32 (the differences taken in double first, as
    Python scalars enter the JAX kernel) unless ``rounded`` is False (a
    float64 run of the plain version)."""
    b1, b2 = float(b1), float(b2)
    consts = (b1, 1.0 - b1, b2, 1.0 - b2, float(adam_eps),
              dim * _HALF_LOG_2PI)
    return tuple(_f32(c) for c in consts) if rounded else consts


def fused_meanfield_advi(density, loc0, log_scale0, n_steps: int,
                         n_particles: int, key, lr_schedule: Callable,
                         b1: float = 0.9, b2: float = 0.999,
                         adam_eps: float = 1e-8,
                         noise: Optional[torch.Tensor] = None, *,
                         _layout=None):
    """Run the whole mean-field SGVB fit of ``density`` in one launch.

    On CUDA tensors this launches the CUDA kernel (or raises); on CPU
    tensors it runs :func:`fused_meanfield_advi_reference`.

    :param density: a built-in density of :data:`DENSITIES`: the
        unconstrained log-posterior over one ``[dim]`` latent.
    :param loc0: ``[dim]`` float32 initial location.
    :param log_scale0: ``[dim]`` float32 initial log standard deviation.
    :param n_steps: Adam steps to run.
    :param n_particles: ELBO particles per step.
    :param key: Philox key ``(k0, k1)`` (see :func:`._random.philox_key`);
        may be None when ``noise`` is given.
    :param lr_schedule: Python callable ``step (float, 0-based) -> lr``
        (``lambda t: lr`` for a constant rate); evaluated on the host.
    :param noise: optional standard normals ``[n_steps, n_particles, dim]``
        replacing the Philox draws (testing hook).
    :param _layout: ``(cluster, warps)`` in place of :func:`advi_layout`'s
        (measurements and tests reach every layout with it).
    :return: ``(loc [dim], log_scale [dim], losses [n_steps])``: the fitted
        parameters and the per-step negative-ELBO estimates.
    """
    dim, n_steps, n_particles = _check(density, loc0, log_scale0, n_steps,
                                       n_particles, noise)
    if _layout is None:
        cluster, warps, _ = advi_layout(dim, n_particles)
    else:
        cluster, warps = (int(v) for v in _layout)
        if not _layout_fits(dim, cluster, warps):
            raise ValueError(
                "fused_meanfield_advi: layout (cluster={}, warps={}) does not "
                "fit dim {}: 1-{} blocks, 1-{} warps, {} bytes of shared "
                "memory at most.".format(cluster, warps, dim, MAX_CLUSTER,
                                         MAX_WARPS, SHARED_BYTES_LIMIT))
    if loc0.device.type == "cpu":
        return fused_meanfield_advi_reference(
            density, loc0, log_scale0, n_steps, n_particles, key,
            lr_schedule, b1, b2, adam_eps, noise)
    if loc0.dtype != torch.float32 or log_scale0.dtype != torch.float32:
        raise TypeError(
            "fused_meanfield_advi takes float32 tensors on the card; got "
            "{} and {}.".format(loc0.dtype, log_scale0.dtype))
    dev = loc0.device
    loc0, log_scale0 = loc0.contiguous(), log_scale0.contiguous()
    table = schedule_table(lr_schedule, n_steps, b1, b2, dev)
    noise_kept = (None if noise is None
                  else noise.to(torch.float32).contiguous())
    out_loc = torch.empty_like(loc0)
    out_ls = torch.empty_like(log_scale0)
    losses = torch.empty((n_steps,), dtype=torch.float32, device=dev)
    k0, k1 = (0, 0) if key is None else (int(k) & 0xFFFFFFFF for k in key)
    launch_kernel(
        fused_meanfield_advi, kernel_library, "zs_fused_meanfield_advi", dev,
        *density_pointers(density, dev), loc0.data_ptr(),
        log_scale0.data_ptr(), table.data_ptr(),
        None if noise_kept is None else noise_kept.data_ptr(), n_steps,
        n_particles, dim, cluster, warps,
        *_adam_constants(b1, b2, adam_eps, dim), k0, k1,
        out_loc.data_ptr(), out_ls.data_ptr(), losses.data_ptr(),
        inputs=(*density.kernel_args(dev), loc0, log_scale0, table,
                noise_kept),
        outputs=(out_loc, out_ls, losses))
    return out_loc, out_ls, losses


fused_meanfield_advi.launches = 0


def _mean64(x, inv_n, dim=None):
    """The sum of ``x`` (over ``dim``, or all of it) accumulated in float64,
    times ``inv_n``, rounded to ``x``'s dtype: the kernel's means."""
    s = (x.sum(dtype=torch.float64) if dim is None
         else x.sum(dim, dtype=torch.float64))
    return (s * inv_n).to(x.dtype)


def fused_meanfield_advi_reference(density, loc0, log_scale0, n_steps: int,
                                   n_particles: int, key,
                                   lr_schedule: Callable, b1: float = 0.9,
                                   b2: float = 0.999, adam_eps: float = 1e-8,
                                   noise: Optional[torch.Tensor] = None):
    """Plain torch version of :func:`fused_meanfield_advi`: the same
    arithmetic step by step, in the kernel's order of operations, on the
    kernel's own Philox draws (or the injected ``noise``), in ``loc0``'s
    dtype and on its device. It is what runs for CPU tensors."""
    dim, n_steps, n_particles = _check(density, loc0, log_scale0, n_steps,
                                       n_particles, noise)
    dev, dtype = loc0.device, loc0.dtype
    table = schedule_table(lr_schedule, n_steps, b1, b2, dev).to(dtype)
    b1f, omb1, b2f, omb2, aeps, loss_const = _adam_constants(
        b1, b2, adam_eps, dim, rounded=dtype == torch.float32)
    inv_n = 1.0 / n_particles
    if noise is None:
        key = tuple(int(k) & 0xFFFFFFFF for k in key)

    def adam(p, g, m, v, lr, c1, c2):
        m = b1f * m + omb1 * g
        v = b2f * v + omb2 * g * g
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + aeps), m, v

    with torch.no_grad():
        loc, ls = loc0.clone(), log_scale0.clone()
        m_l, v_l, m_s, v_s = (torch.zeros_like(loc) for _ in range(4))
        losses = torch.empty((n_steps,), dtype=dtype, device=dev)
        for t in range(n_steps):
            if noise is not None:
                eps = noise[t].to(dtype)
            else:
                eps = philox_normal(key, t, (n_particles, dim),
                                    STREAM_ADVI_NOISE, dev).to(dtype)
            se = torch.exp(ls) * eps
            f_vals, gz = density.value_and_grad(loc + se)
            g_loc = -_mean64(gz, inv_n, 0)
            g_ls = -_mean64(gz * se, inv_n, 0) - 1.0
            losses[t] = (-_mean64(f_vals, inv_n)
                         - 0.5 * _mean64(eps * eps, inv_n) - loss_const
                         - ls.sum(dtype=torch.float64).to(dtype))
            lr, c1, c2 = table[t, 0], table[t, 1], table[t, 2]
            loc, m_l, v_l = adam(loc, g_loc, m_l, v_l, lr, c1, c2)
            ls, m_s, v_s = adam(ls, g_ls, m_s, v_s, lr, c1, c2)
    return loc, ls, losses
