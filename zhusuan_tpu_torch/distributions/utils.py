"""Shared distribution helpers.

Port of ``zhusuan_tpu/distributions/utils.py`` (parity: reference
``zhusuan/distributions/utils.py``): ``log_combination`` (utils.py:19),
explicit broadcasting (utils.py:36-78), the dtype assertions
(utils.py:111-184) and the open-interval standard uniform
(utils.py:311-324), plus the conversion of parameters to tensors on one
device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from zhusuan_tpu_torch.framework.arith import unwrap

__all__ = [
    "log_combination",
    "explicit_broadcast",
    "maybe_explicit_broadcast",
    "is_same_dynamic_shape",
    "assert_same_float_dtype",
    "assert_same_float_and_int_dtype",
    "open_interval_standard_uniform",
    "broadcast_shapes",
    "param_device",
    "as_param",
]

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_INT_DTYPES = (torch.int16, torch.int32, torch.int64)


def is_same_dynamic_shape(x, y) -> bool:
    """Whether two tensors have the same shape (reference
    ``distributions/utils.py:81-108``; shapes are static, so a plain
    bool)."""
    return tuple(torch.as_tensor(unwrap(x)).shape) == tuple(
        torch.as_tensor(unwrap(y)).shape)


def log_combination(n, ks):
    """The log multinomial coefficient ``lgamma(n + 1) - sum_i lgamma(ks_i
    + 1)``, ``ks`` summed over its last axis (reference
    ``distributions/utils.py:19-33``).

    :param n: number of trials, broadcastable to ``ks.shape[:-1]``.
    :param ks: counts per category on the last axis.
    """
    ks = torch.as_tensor(unwrap(ks))
    n = torch.as_tensor(unwrap(n), device=ks.device)
    return torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(ks + 1.0), dim=-1)


def explicit_broadcast(x, y, x_name="x", y_name="y"):
    """``x`` and ``y`` broadcast to their common shape, raising ValueError
    when they cannot be (reference ``distributions/utils.py:36-49``)."""
    x, y = torch.as_tensor(unwrap(x)), torch.as_tensor(unwrap(y))
    try:
        return torch.broadcast_tensors(x, y)
    except RuntimeError:
        raise ValueError(
            "{} and {} cannot broadcast to match. ({} vs. {})".format(
                x_name, y_name, tuple(x.shape), tuple(y.shape)))


def maybe_explicit_broadcast(x, y, x_name="x", y_name="y"):
    """Alias of :func:`explicit_broadcast` (reference
    ``distributions/utils.py:52-78``)."""
    return explicit_broadcast(x, y, x_name, y_name)


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
    return _assert_same_dtype_in(tensors_with_name, dtype, _FLOAT_DTYPES,
                                 "float")


def assert_same_float_and_int_dtype(tensors_with_name, dtype=None):
    """Like :func:`assert_same_float_dtype`, but integer dtypes are
    admitted too (reference ``distributions/utils.py:158-174``)."""
    return _assert_same_dtype_in(tensors_with_name, dtype,
                                 _FLOAT_DTYPES + _INT_DTYPES, "float or int")


def _assert_same_dtype_in(tensors_with_name, dtype, allowed, kind):
    expected = dtype
    for tensor, name in tensors_with_name:
        if tensor is None:
            continue
        if isinstance(tensor, (int, float)) and not isinstance(tensor, bool):
            continue
        t_dtype = _dtype_of(tensor)
        if expected is None:
            if t_dtype not in allowed:
                raise TypeError(
                    "{}({}) must have a {} dtype.".format(name, t_dtype,
                                                         kind))
            expected = t_dtype
        elif t_dtype != expected:
            raise TypeError(
                "{}({}) must have the same dtype as other parameters "
                "({}).".format(name, t_dtype, expected))
    return torch.float32 if expected is None else expected


def open_interval_standard_uniform(generator, shape, dtype=torch.float32,
                                   device=None):
    """Uniforms on the open interval (0, 1) (reference
    ``distributions/utils.py:311-324``): the JAX package's ``uniform(key,
    shape, minval=finfo(dtype).tiny, maxval=1)``, so that ``log(u)`` (the
    Gumbel, logistic and Laplace samplers) never sees 0. ``torch.rand``
    draws on [0, 1); the map ``u (1 - tiny) + tiny``, floored at ``tiny``,
    is the one the JAX package applies to its [0, 1) bits.

    :param generator: a ``torch.Generator`` on ``device``.
    :param device: the device (the generator's when None).
    """
    device = generator.device if device is None else device
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=device)
    return torch.clamp(u * (1.0 - tiny) + tiny, min=tiny)


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
