"""Standalone normal and uniform samplers: a hand-written CUDA kernel and
its plain version.

Replaces the Pallas TPU kernels ``zhusuan_tpu/ops/random.py::tpu_normal``
(``pallas_call`` at :83) and ``tpu_uniform`` (:117): a 2-D float32 array of
standard normals (Box-Muller on mantissa uniforms, ``u1`` clamped at 1e-7)
or of uniforms in [0, 1), written in one pass (``csrc/random.cu``). No
sampler of the package draws from them by default; they are an entry point
of their own, as in the JAX package.

The TPU kernels seed the chip's hardware PRNG once per ~1 MB block of rows
and keep only the cosine output in a block with an odd row count. Neither
comes over: the bits are Philox4x32-10 (``csrc/philox.cuh``) counted by
``(0, row, group of 4 columns, stream)``, so a value depends on the key and
its own position alone, and the plain versions
(:func:`._random.philox_normal`, :func:`._random.philox_uniform_rows`) give
the same bits. The stream differs from the TPU's and from ``torch.randn``
by design.

Bound on an H100: the output's bytes, written once, over 3.35 TB/s. Where
``cols`` is a multiple of 4 the kernel writes a group of 4 columns as one
16-byte store; other widths take 4-byte stores. The bits are the same.
"""

from __future__ import annotations

import ctypes

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel
from zhusuan_tpu_torch.ops._random import (
    STREAM_RANDOM_NORMAL,
    STREAM_RANDOM_UNIFORM,
    philox_normal,
    philox_uniform_rows,
)

__all__ = ["gpu_normal", "gpu_normal_reference", "gpu_uniform",
           "gpu_uniform_reference", "random_supported"]

_MAX_ROWS = 2 ** 32 - 1  # the row is one 32-bit word of the Philox counter
_MAX_COLS = 2 ** 31 - 1


def random_supported(shape) -> bool:
    """Whether the kernels write an array of this shape: 2-D, at least one
    row and one column, rows below 2^32."""
    if len(shape) != 2:
        return False
    rows, cols = (int(s) for s in shape)
    return 1 <= rows <= _MAX_ROWS and 1 <= cols <= _MAX_COLS


def kernel_library():
    """Build (at first use) and load ``csrc/random.cu``; returns ``(cdll,
    build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("random")
    if not getattr(lib, "_zs_typed", False):
        ptr, u32 = ctypes.c_void_p, ctypes.c_uint32
        for fn in (lib.zs_gpu_normal, lib.zs_gpu_uniform):
            fn.argtypes = [ptr, ctypes.c_longlong, ctypes.c_int, u32, u32,
                           ptr]
            fn.restype = ctypes.c_int
        lib.zs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def _check(fn_name, key, shape):
    shape = tuple(int(s) for s in shape)
    if not random_supported(shape):
        raise ValueError(
            "{} takes a 2-D shape (rows, cols) with rows, cols >= 1; got "
            "{}.".format(fn_name, shape))
    k0, k1 = key
    return shape, (int(k0) & 0xFFFFFFFF, int(k1) & 0xFFFFFFFF)


_CARD = torch.device("cuda", 0)


def _device(device):
    if device is None:
        return _CARD
    return device if isinstance(device, torch.device) else torch.device(device)


def _launch(wrapper, entry, key, shape, device):
    out = torch.empty(shape, dtype=torch.float32, device=device)
    launch_kernel(wrapper, kernel_library, entry, device, out.data_ptr(),
                  shape[0], shape[1], *key, inputs=(), outputs=(out,))
    return out


def gpu_normal(key, shape, device=None):
    """Standard normal samples, float32, of 2-D ``shape``.

    On a CUDA ``device`` (the default: the card) this launches the CUDA
    kernel or raises; on the CPU it runs :func:`gpu_normal_reference`.
    Replaces ``zhusuan_tpu/ops/random.py::tpu_normal``.

    :param key: Philox key ``(k0, k1)`` (see :func:`._random.philox_key`);
        one key always gives the same array.
    :param shape: ``(rows, cols)``.
    :param device: where to draw; None is ``cuda:0``.
    """
    shape, key = _check("gpu_normal", key, shape)
    device = _device(device)
    if device.type == "cpu":
        return gpu_normal_reference(key, shape, device)
    return _launch(gpu_normal, "zs_gpu_normal", key, shape, device)


gpu_normal.launches = 0


def gpu_uniform(key, shape, device=None):
    """Uniform samples in [0, 1), float32, of 2-D ``shape``; arguments as
    :func:`gpu_normal`. Replaces ``zhusuan_tpu/ops/random.py::
    tpu_uniform``."""
    shape, key = _check("gpu_uniform", key, shape)
    device = _device(device)
    if device.type == "cpu":
        return gpu_uniform_reference(key, shape, device)
    return _launch(gpu_uniform, "zs_gpu_uniform", key, shape, device)


gpu_uniform.launches = 0


def gpu_normal_reference(key, shape, device=None):
    """Plain torch version of :func:`gpu_normal`: the same Philox bits
    through the same Box-Muller, on ``device`` (None: the CPU)."""
    shape, key = _check("gpu_normal", key, shape)
    return philox_normal(key, 0, shape, STREAM_RANDOM_NORMAL, device)


def gpu_uniform_reference(key, shape, device=None):
    """Plain torch version of :func:`gpu_uniform`."""
    shape, key = _check("gpu_uniform", key, shape)
    return philox_uniform_rows(key, 0, shape, STREAM_RANDOM_UNIFORM, device)
