"""Shared distribution helpers.

Port of the helpers of ``zhusuan_tpu/distributions/utils.py`` that
``Normal`` and ``MultivariateNormalCholesky`` use (parity: reference
``zhusuan/distributions/utils.py:140-155``), plus the conversion of
parameters to tensors on one device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from zhusuan_tpu_torch.framework.arith import unwrap

__all__ = ["assert_same_float_dtype", "broadcast_shapes", "param_device",
           "as_param"]

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def broadcast_shapes(*shapes: Sequence[int]) -> Tuple[int, ...]:
    """Static broadcast of shapes, raising ValueError on incompatibility."""
    try:
        return tuple(torch.broadcast_shapes(*[tuple(s) for s in shapes]))
    except RuntimeError:
        raise ValueError(
            "Shapes cannot broadcast to match: {}".format(shapes))


def _dtype_of(t):
    t = unwrap(t)
    if isinstance(t, torch.Tensor):
        return t.dtype
    return torch.from_numpy(np.asarray(t)).dtype


def assert_same_float_dtype(tensors_with_name, dtype=None):
    """Check that all named tensors share one floating dtype; return it.

    Python scalars are weakly typed: they take the dtype of the other
    parameters, float32 when all are scalars (JAX's weak-type rule).

    :param tensors_with_name: list of ``(array_like, name)`` pairs.
    :param dtype: if given, the required ``torch.dtype``.
    """
    expected = dtype
    for tensor, name in tensors_with_name:
        if tensor is None:
            continue
        if isinstance(tensor, (int, float)) and not isinstance(tensor, bool):
            continue
        t_dtype = _dtype_of(tensor)
        if expected is None:
            if t_dtype not in _FLOAT_DTYPES:
                raise TypeError(
                    "{}({}) must have a float dtype.".format(name, t_dtype))
            expected = t_dtype
        elif t_dtype != expected:
            raise TypeError(
                "{}({}) must have the same dtype as other parameters "
                "({}).".format(name, t_dtype, expected))
    return torch.float32 if expected is None else expected


def param_device(*params) -> torch.device:
    """The device of the first tensor among ``params`` (the CPU when none
    is a tensor)."""
    for p in params:
        p = unwrap(p)
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def as_param(x, dtype, device) -> torch.Tensor:
    """``x`` (a number, array, tensor or node) as a tensor of ``dtype`` on
    ``device``; a tensor already so is returned as it is."""
    return torch.as_tensor(unwrap(x), dtype=dtype, device=device)
