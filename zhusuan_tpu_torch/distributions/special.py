"""Special distributions: Empirical and Implicit.

Port of ``zhusuan_tpu/distributions/special.py`` (parity: reference
``zhusuan/legacy/distributions/special.py``: Empirical at special.py:19-93,
Implicit at special.py:96-171). These serve GAN-style models where a node
carries samples produced elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.framework.arith import unwrap

__all__ = ["Empirical", "Implicit"]


def _torch_dtype(dtype) -> torch.dtype:
    """``dtype`` (a ``torch.dtype``, a numpy dtype or its name) as a
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


class Empirical(Distribution):
    """A distribution with a declared shape and dtype but no sampler or
    density: for nodes that are always observed (e.g. a GAN's data node).

    :param dtype: the sample dtype (``torch.dtype``, numpy dtype or name).
    :param batch_shape: static batch shape of the node.
    :param value_shape: static value shape (default scalar; None is
        scalar too, as the legacy wrappers pass it).
    :param is_continuous: default: whether ``dtype`` is a float dtype.
    """

    def __init__(self, dtype, batch_shape=(), value_shape=(),
                 is_continuous=None, group_ndims: int = 0, **kwargs):
        self._explicit_batch_shape = tuple(int(s) for s in batch_shape or ())
        self._explicit_value_shape = tuple(int(s) for s in value_shape or ())
        dtype = _torch_dtype(dtype)
        if is_continuous is None:
            is_continuous = dtype.is_floating_point
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=is_continuous,
            is_reparameterized=False,
            group_ndims=group_ndims,
            **kwargs,
        )

    def _batch_shape(self):
        return self._explicit_batch_shape

    def _value_shape(self):
        return self._explicit_value_shape

    def _sample(self, generator, n_samples, eps):
        raise ValueError("You can not sample from an Empirical distribution.")

    def _log_prob(self, given):
        raise ValueError(
            "An empirical distribution has no log-probability density.")

    def _prob(self, given):
        raise ValueError(
            "An empirical distribution has no probability density.")


class Implicit(Distribution):
    """A distribution wrapping samples produced elsewhere, with a delta-like
    density: ``prob`` is 1 where ``given == samples`` and 0 elsewhere, and
    for a float dtype ``+inf`` and ``-inf`` (the reference's ``(2 equal -
    1) inf``, special.py:164-169); ``log_prob`` is ``log(prob)``.

    :param samples: the wrapped samples (their device is the node's).
    :param value_shape: trailing value shape of one sample event.
    """

    def __init__(self, samples, value_shape=(), group_ndims: int = 0,
                 **kwargs):
        self._samples = torch.as_tensor(unwrap(samples))
        self._explicit_value_shape = tuple(int(s) for s in value_shape or ())
        dtype = self._samples.dtype
        kwargs.setdefault("device", self._samples.device)
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=dtype.is_floating_point,
            is_reparameterized=False,
            group_ndims=group_ndims,
            **kwargs,
        )

    samples = property(lambda self: self._samples)

    def _batch_shape(self):
        nv = len(self._explicit_value_shape)
        shape = tuple(self._samples.shape)
        return shape[:len(shape) - nv] if nv else shape

    def _value_shape(self):
        return self._explicit_value_shape

    def _sample(self, generator, n_samples, eps):
        # The "sample" is the wrapped tensor, tiled along a new leading axis.
        return self._samples.expand((n_samples,) + tuple(self._samples.shape))

    def _log_prob(self, given):
        return torch.log(self._prob(given))

    def _prob(self, given):
        prob = (given == self._samples).to(self.param_dtype)
        if self.is_continuous:
            return (2.0 * prob - 1.0) * float("inf")
        return prob
