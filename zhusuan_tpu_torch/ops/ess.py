"""Effective sample size of every column of ``[n, cols]`` draws: a
hand-written CUDA kernel (``csrc/ess.cu``) that reads the draws once.

Replaces no TPU kernel (the JAX package computes ESS with numpy on the
host). It replaces, on the card, the batched FFT path of
:func:`~zhusuan_tpu_torch.diagnostics.ess_batch_device`, which makes a
dozen passes over ``[n, cols]`` temporaries; the estimator is the same
(``diagnostics.py``'s header), computed in float32 after the mean is taken
out, so it is held to the float64 estimator by tolerance.

:func:`~zhusuan_tpu_torch.diagnostics.ess_batch_device` routes a CUDA
tensor with contiguous columns here when :func:`ess_layout` takes its
shape and dtype: float32, bfloat16 or float16, ``n >= 2``, and ``n`` rows
of a tile within a block's shared memory. Everything else (the CPU,
float64, more rows, strided columns) stays on the FFT path.
"""

from __future__ import annotations

import ctypes

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel

__all__ = ["ess_layout", "fused_ess"]

#: Columns a block stages (``csrc/ess.cu``: ``kTile``), and the lags a
#: pass computes (``kGroup``): the tile keeps that many zero rows below
#: the last.
TILE = 32
GROUP = 8
MAX_WARPS = 8
#: Dynamic shared memory a block may have on an H100.
SHARED_MAX = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def ess_layout(n: int, cols: int, dtype):
    """Warps a block of the kernel takes for ``[n, cols]`` draws of
    ``dtype``, or None where it does not take them: a dtype other than
    float32, bfloat16 and float16, ``n < 2``, no column, or ``n`` rows of a
    tile beyond a block's shared memory.

    One warp for each 32 rows, at most :data:`MAX_WARPS`. The shared memory
    is ``csrc/ess.cu``'s (``tile_floats`` and ``side_floats``), written again
    here to route by: ``n + GROUP`` rows of ``TILE + 1`` float32 (the
    widened draws and zero rows, a padded row stride), the warps' partial
    sums (``GROUP`` a column each) and three floats a column; the launch
    refuses a layout past :data:`SHARED_MAX` all the same."""
    if dtype not in _DTYPES or n < 2 or cols < 1:
        return None
    warps = min(MAX_WARPS, -(-n // 32))
    floats = ((n + GROUP) * (TILE + 1) + warps * GROUP * TILE
              + 3 * TILE + 2)
    return warps if 4 * floats <= SHARED_MAX else None


def kernel_library():
    """Build (at first use) and load ``csrc/ess.cu``; returns ``(cdll,
    build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("ess")
    if not getattr(lib, "_zs_typed", False):
        ptr = ctypes.c_void_p
        lib.zs_fused_ess.argtypes = [ptr, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ptr, ptr]
        lib.zs_fused_ess.restype = ctypes.c_int
        lib.zs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def fused_ess(samples):
    """Per-column ESS of ``[n, cols]`` draws on the card -> ``[cols]``
    float32 on their device, in one launch (counted on
    ``fused_ess.launches``).

    Takes a CUDA tensor that :func:`ess_layout` takes, whose columns are
    contiguous (any row stride: a view is read in place, never copied);
    raises on anything else, which
    :func:`~zhusuan_tpu_torch.diagnostics.ess_batch_device` keeps on its
    FFT path.
    """
    samples = torch.as_tensor(samples)
    if samples.ndim != 2:
        raise ValueError("fused_ess takes [n, cols] draws; got shape {}."
                         .format(tuple(samples.shape)))
    n, cols = samples.shape
    warps = ess_layout(n, cols, samples.dtype)
    if (not samples.is_cuda or warps is None
            or (cols > 1 and samples.stride(1) != 1)):
        raise ValueError(
            "fused_ess takes CUDA float32, bfloat16 or float16 draws with "
            "contiguous columns, 2 <= n and n rows of a tile in shared "
            "memory; got {} {} {} with strides {}.".format(
                samples.device, samples.dtype, tuple(samples.shape),
                samples.stride()))
    out = torch.empty(cols, dtype=torch.float32, device=samples.device)
    launch_kernel(fused_ess, kernel_library, "zs_fused_ess", samples.device,
                  samples.data_ptr(), n, cols, samples.stride(0),
                  _DTYPES[samples.dtype], warps, out.data_ptr(),
                  inputs=(samples,), outputs=(out,))
    return out


fused_ess.launches = 0
