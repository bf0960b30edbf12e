"""Fused HMC transition: a hand-written CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/hmc_step.py::
fused_hmc_step``. One launch runs one whole HMC transition for every chain:
the momentum draw, the boundary-aware leapfrog trajectory, both
Hamiltonians with the non-finite -> reject guard, and the per-chain MH
select. The kernel (``csrc/hmc_step.cu``, CUDA C++ for ``sm_90a``) gives
each chain one warp and keeps the chain's state in registers for the whole
trajectory. It reads q once and writes q' and p0 once, so at the main
path's 32768 x 100 it is bound by instruction latency in the per-warp loop
(Philox, Box-Muller, six gradient evaluations, four warp reductions), not
by device-memory bandwidth: 0.065 ms per launch replayed from a CUDA graph
on an H100 80GB HBM3 (700 W limit), 5.5x its device-memory bound. The same
library holds the ChEES transition (:mod:`.chees_step`) and the trajectory
alone (:mod:`.leapfrog`), instantiations of one kernel body.

The Pallas kernel traces any user density into its body. A CUDA kernel
cannot, so the kernel computes the built-in densities of
:mod:`.densities` named in :data:`DENSITIES`, whose parameters it reads
through pointers, and the tempered bridge between two of them
(:class:`~.densities.TemperedLogJoint`, the temperature a device scalar;
``csrc/hmc_step.cu``'s ``zs_fused_tempered_hmc_step``): annealed SMC's
HMC moves; and the built-ins of :data:`BUILTIN_DENSITIES`, float32 only
(``csrc/hmc_builtins.cu``'s ``zs_fused_builtin_hmc_step``, the same kernel
body in a library of its own): the whitened Gaussians of dense
preconditioning, Neal's funnel and NeuTra's lifted density, and the
regression and change-point posteriors with their data, the latter reading
each chain's change point from the sampler's ``observed`` (a pointer the
launch passes, set anew at every launch). Any other log-joint takes the
sampler's plain path.

Random numbers: Philox4x32-10 written into the kernel, keyed by a pair of
ints drawn once from a ``torch.Generator`` and counted by (iteration,
chain, group of 4 elements, stream) (:mod:`._random`). The plain version
draws the same numbers in torch. ``noise=(eps, u_mh)`` replaces the draws
exactly in both; it is a testing hook, not a user feature.

Outputs match the TPU kernel: ``(q' [c, d] in q's dtype, p0 [c, d],
acceptance [c], old_log_prob [c], new_log_prob of the kept point [c],
old_h [c], new_h [c])``, float32 on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import (
    STREAM_MH,
    STREAM_MOMENTUM,
    philox_normal,
    philox_uniform,
)
from zhusuan_tpu_torch.ops.densities import (
    BuiltinDensity,
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
    GaussianLinearRegressionLogJoint,
    NealFunnelLogJoint,
    NeuTraLogJoint,
    PoissonChangepointLogJoint,
    TemperedLogJoint,
    WhitenedLogJoint,
)

__all__ = [
    "BUILTIN_DENSITIES",
    "DENSITIES",
    "DiagonalGaussianLogJoint",
    "EquicorrelatedGaussianLogJoint",
    "STEP_DENSITIES",
    "TemperedLogJoint",
    "builtin_library",
    "fused_hmc_step",
    "fused_hmc_step_reference",
    "hmc_step_supported",
    "kernel_library",
]

# One lane holds up to 4 groups of 4 elements (csrc/hmc_step.cu dispatch).
MAX_DIM = 512
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: The built-in densities the HMC-family kernels evaluate.
DENSITIES = (DiagonalGaussianLogJoint, EquicorrelatedGaussianLogJoint)
#: The built-ins K1 alone evaluates, float32 only.
BUILTIN_DENSITIES = (WhitenedLogJoint, NealFunnelLogJoint, NeuTraLogJoint,
                     GaussianLinearRegressionLogJoint,
                     PoissonChangepointLogJoint)
#: What the whole-step kernel (K1) takes: those, the tempered bridge
#: between two of them and :data:`BUILTIN_DENSITIES`.
STEP_DENSITIES = DENSITIES + (TemperedLogJoint,) + BUILTIN_DENSITIES


def hmc_step_supported(q_shape, dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA kernel takes a ``[n_chains, dim]`` state of this
    shape (and dtype, when given)."""
    if len(q_shape) != 2:
        return False
    c, d = q_shape
    if not (1 <= c < 2 ** 31 and 1 <= d <= MAX_DIM):
        return False
    return dtype is None or dtype in KERNEL_DTYPES


def kernel_library():
    """Build (at first use) and load the HMC-family kernels' shared
    library; returns ``(cdll, build_record)`` (see
    :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("hmc_step")
    if not getattr(lib, "_zs_typed", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.zs_fused_hmc_step.argtypes = (
            [ptr, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
             u32, u32, u32] + [ptr] * 8)
        lib.zs_fused_tempered_hmc_step.argtypes = (
            [ptr, i32, ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr,
             i32, i32, i32, u32, u32, u32] + [ptr] * 8)
        lib.zs_fused_chees_step.argtypes = (
            [ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, u32, u32,
             u32] + [ptr] * 7)
        lib.zs_fused_leapfrog.argtypes = (
            [ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32]
            + [ptr] * 3)
        for fn in (lib.zs_fused_hmc_step, lib.zs_fused_tempered_hmc_step,
                   lib.zs_fused_chees_step, lib.zs_fused_leapfrog):
            fn.restype = i32
        lib.zs_cuda_error_string.argtypes = [i32]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def builtin_library():
    """Build (at first use) and load K1's library for the built-ins of
    :data:`BUILTIN_DENSITIES` (``csrc/hmc_builtins.cu``, the same kernel
    body as :func:`kernel_library`'s, built beside it); returns ``(cdll,
    build_record)``."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("hmc_builtins")
    if not getattr(lib, "_zs_typed", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.zs_fused_builtin_hmc_step.argtypes = (
            [ptr, ptr, i32, i32] + [ptr] * 5 + [i32] * 4 + [ptr] * 3
            + [i32, i32, i32, u32, u32, u32] + [ptr] * 8)
        lib.zs_fused_builtin_hmc_step.restype = i32
        lib.zs_cuda_error_string.argtypes = [i32]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def check_density(fn_name, density, densities, d):
    """Raise unless ``density`` is one of the built-ins ``densities`` over
    a last axis of size ``d``."""
    if not isinstance(density, densities):
        raise TypeError(
            "{} evaluates only the built-in densities {}; got {!r}.".format(
                fn_name, [c.__name__ for c in densities], type(density)))
    if density.dim != d:
        raise ValueError("density has dim {}, q has dim {}.".format(
            density.dim, d))


def check_device(q, *others):
    """Raise unless ``q`` is on the CPU or a CUDA device and every other
    tensor is on its device."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("q must be on the CPU or a CUDA device; got "
                         "{}.".format(q.device))
    for name, v in others:
        if v.device != q.device:
            raise ValueError("{} is on {}, q on {}.".format(name, v.device,
                                                            q.device))


def check_noise(noise, q):
    """Raise unless ``noise`` is None or ``(eps [c, d], u [c])`` on q's
    device."""
    if noise is None:
        return
    c, d = q.shape
    eps, u = noise
    if tuple(eps.shape) != (c, d) or tuple(u.shape) != (c,):
        raise ValueError(
            "noise must be (eps [{0}, {1}], u [{0}]); got {2} and "
            "{3}.".format(c, d, tuple(eps.shape), tuple(u.shape)))
    if eps.device != q.device or u.device != q.device:
        raise ValueError("noise must be on q's device {}.".format(q.device))


def _check_inputs(density, q, mass, noise, observed):
    if q.ndim != 2:
        raise ValueError(
            "q must be [n_chains, dim]; got shape {}.".format(tuple(q.shape)))
    c, d = q.shape
    check_density("fused_hmc_step", density, STEP_DENSITIES, d)
    if tuple(mass.shape) != (1, d):
        raise ValueError("mass must be [1, {}]; got {}.".format(
            d, tuple(mass.shape)))
    check_device(q, ("mass", mass))
    check_noise(noise, q)
    observed = observed or {}
    for name in density.chain_observed:
        v = observed.get(name)
        if not isinstance(v, torch.Tensor) or tuple(v.shape) != (c, 1):
            raise ValueError(
                "{} reads the observation {!r} as a [{}, 1] tensor; got "
                "{!r}.".format(type(density).__name__, name, c,
                               None if v is None else getattr(v, "shape", v)))
        check_device(q, (name, v))


def _builtin_layout(density, dev):
    """``(base id, aux arrays, rows of the data table, shared floats a
    block and a warp)`` of a built-in of :data:`BUILTIN_DENSITIES`."""
    aux = density.kernel_args(dev, aux=True)
    base = getattr(density, "base", None)
    base_id = -1 if base is None else base.kernel_id
    d = density.dim
    if isinstance(density, WhitenedLogJoint):
        return base_id, aux, 0, d * (d | 1), 2 * WhitenedLogJoint.MAX_DIM
    if isinstance(density, NeuTraLogJoint):
        return (base_id, aux, 0, aux[0].numel(),
                64 + 32 * len(density.flows))
    if isinstance(density, (GaussianLinearRegressionLogJoint,
                            PoissonChangepointLogJoint)):
        return base_id, aux, density.kernel_args(dev)[0].shape[0], 0, 0
    return base_id, aux, 0, 0, 0


def device_scalar(value, dev, dtype=torch.float32):
    """``value`` (a tensor or a number) as a ``[1]`` tensor on ``dev``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=dev, dtype=dtype).reshape(1)
    return torch.full((1,), value, dtype=dtype, device=dev)


def density_pointers(density: BuiltinDensity, dev):
    """``(kernel_id, dens0, dens1)``: the density's id and its parameter
    arrays' device pointers (None for an unused one)."""
    p0, p1 = density.kernel_args(dev)
    return (density.kernel_id, p0.data_ptr(),
            None if p1 is None else p1.data_ptr())


def noise_pointers(noise):
    """float32 contiguous copies of ``noise`` and their pointers, or
    ``(None, (None, None))``."""
    if noise is None:
        return None, (None, None)
    kept = tuple(v.to(torch.float32).contiguous() for v in noise)
    return kept, tuple(v.data_ptr() for v in kept)


def fused_hmc_step(density, q, mass, step_size, n_leapfrogs: int, key,
                   t: int, *, noise=None, observed=None):
    """Run one full HMC transition for every chain.

    On a CUDA tensor this launches the CUDA kernel (or raises); on a CPU
    tensor it runs :func:`fused_hmc_step_reference`.

    :param density: a built-in density of :data:`STEP_DENSITIES` over
        ``q`` (a :class:`~.densities.TemperedLogJoint`'s ``beta`` a float
        or a scalar tensor on q's device).
    :param q: ``[n_chains, dim]`` positions, float32 or bfloat16 on the
        card (bfloat16 is read and written as such; all compute is f32).
    :param mass: ``[1, dim]`` diagonal mass (float32 on the card).
    :param step_size: scalar tensor on q's device, or a float.
    :param n_leapfrogs: leapfrog steps (the trajectory has
        ``n_leapfrogs + 1`` sub-steps).
    :param key: Philox key ``(k0, k1)`` (see :func:`._random.philox_key`).
    :param t: iteration number, the first word of the Philox counter.
    :param noise: optional ``(eps [c, d], u_mh [c])`` standard normals and
        uniforms replacing the draws (testing hook).
    :param observed: the sampler's observations; a built-in with
        ``chain_observed`` reads those leaves (``[c, 1]`` each) for each
        chain, and every other leaf is ignored, as the built-ins do.
    :return: ``(q', p0, acceptance, old_log_prob, new_log_prob, old_h,
        new_h)``.
    """
    _check_inputs(density, q, mass, noise, observed)
    if q.device.type == "cpu":
        return fused_hmc_step_reference(density, q, mass, step_size,
                                        n_leapfrogs, key, t, noise=noise,
                                        observed=observed)
    if q.dtype not in KERNEL_DTYPES or mass.dtype != torch.float32:
        raise TypeError(
            "the CUDA kernel takes float32 or bfloat16 q and float32 mass; "
            "got {} and {}.".format(q.dtype, mass.dtype))
    if not hmc_step_supported(q.shape, q.dtype):
        raise ValueError("the CUDA kernel takes 1 <= dim <= {}; got shape "
                         "{}.".format(MAX_DIM, tuple(q.shape)))
    if not (q.is_contiguous() and mass.is_contiguous()):
        raise ValueError("q and mass must be contiguous.")
    if int(n_leapfrogs) < 0:
        raise ValueError("n_leapfrogs must be >= 0.")
    c, d = q.shape
    dev = q.device
    ss = device_scalar(step_size, dev)
    _kept, (eps_ptr, u_ptr) = noise_pointers(noise)
    out_q = torch.empty_like(q)
    out_p = torch.empty((c, d), dtype=torch.float32, device=dev)
    vecs = [torch.empty((c,), dtype=torch.float32, device=dev)
            for _ in range(5)]
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    if isinstance(density, BUILTIN_DENSITIES):
        if q.dtype != torch.float32:
            raise TypeError("the CUDA kernel takes {} on float32 q only; got "
                            "{}.".format(type(density).__name__, q.dtype))
        why = density.kernel_ineligible()
        if why is not None:
            raise ValueError("the CUDA kernel cannot take this {}: {}."
                             .format(type(density).__name__, why))
        base_id, aux, n_rows, smem_block, smem_warp = _builtin_layout(
            density, dev)
        # The per-chain values (the change point) are read through a
        # pointer set at this launch: the sampler's observation of the
        # sweep.
        held = [observed[k].to(torch.float32).contiguous()
                for k in density.chain_observed]
        library, entry = builtin_library, "zs_fused_builtin_hmc_step"
        head = (q.data_ptr(), mass.data_ptr(), density.kernel_id, base_id,
                *(None if v is None else v.data_ptr()
                  for v in (*density.kernel_args(dev), *aux)),
                held[0].data_ptr() if held else None, 1, n_rows,
                smem_block, smem_warp)
        params = (*density.kernel_args(dev), *aux, *held)
    elif isinstance(density, TemperedLogJoint):
        beta = device_scalar(density.beta, dev)
        library, entry = kernel_library, "zs_fused_tempered_hmc_step"
        head = (q.data_ptr(), int(q.dtype == torch.bfloat16), mass.data_ptr(),
                *density_pointers(density.prior, dev),
                *density_pointers(density.target, dev), beta.data_ptr())
        params = (*density.prior.kernel_args(dev),
                  *density.target.kernel_args(dev), beta)
    else:
        library, entry = kernel_library, "zs_fused_hmc_step"
        head = (q.data_ptr(), int(q.dtype == torch.bfloat16), mass.data_ptr(),
                *density_pointers(density, dev))
        params = density.kernel_args(dev)
    launch_kernel(
        fused_hmc_step, library, entry, dev,
        *head, ss.data_ptr(), eps_ptr, u_ptr,
        c, d, int(n_leapfrogs), k0, k1, int(t) & 0xFFFFFFFF,
        out_q.data_ptr(), out_p.data_ptr(),
        *[v.data_ptr() for v in vecs],
        inputs=(q, mass, *params, ss, *(_kept or ())),
        outputs=(out_q, out_p, *vecs))
    acc, old_lp, new_lp, old_h, new_h = vecs
    return out_q, out_p, acc, old_lp, new_lp, old_h, new_h


fused_hmc_step.launches = 0


def fused_hmc_step_reference(density, q, mass, step_size, n_leapfrogs: int,
                             key, t: int, *, noise=None, observed=None):
    """Plain torch version of :func:`fused_hmc_step`: the kernel's Philox
    draws (or the injected ``noise``), then the sampler's plain transition
    :func:`..mcmc.base.hmc_transition` (autograd gradient). Computes in
    float32 for bfloat16 ``q`` and in ``q``'s dtype otherwise; ``q'`` comes
    back in ``q``'s dtype."""
    from zhusuan_tpu_torch.mcmc import base

    _check_inputs(density, q, mass, noise, observed)
    if noise is None:
        eps = philox_normal(key, t, q.shape, STREAM_MOMENTUM, q.device)
        u = philox_uniform(key, t, (q.shape[0],), STREAM_MH, q.device)
    else:
        eps, u = noise
    name = density.name
    compute = torch.float32 if q.dtype == torch.bfloat16 else q.dtype
    x0 = {name: q.to(compute)}
    m = {name: mass.to(compute)}
    p0 = base.tree_random_momentum(None, x0, m, {name: eps})
    log_post = base.make_log_joint_fn(density, observed or {})
    with torch.no_grad():
        out_q, acc, old_lp, new_lp, old_h, new_h, *_ = base.hmc_transition(
            x0, p0, u, torch.as_tensor(step_size, dtype=compute,
                                       device=q.device),
            int(n_leapfrogs), base.make_grad_fn(log_post), log_post, m, 1)
    return (out_q[name].to(q.dtype), p0[name], acc, old_lp, new_lp, old_h,
            new_h)
