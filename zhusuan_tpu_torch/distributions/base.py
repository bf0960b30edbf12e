"""Distribution abstract base class.

Port of ``zhusuan_tpu/distributions/base.py`` (parity: reference
``zhusuan/distributions/base.py``: shape contract at base.py:23-46,
``sample`` at base.py:237-263, ``log_prob``/``prob`` with the
``group_ndims`` reduction at base.py:291-320, ``path_param`` at
base.py:150-157).

Divergences from the JAX package: ``sample`` takes an explicit
``torch.Generator`` on the parameters' device in place of a PRNG key, and
an ``eps=`` testing hook that supplies the distribution's base draws, so
tests can feed both packages the same numbers; ``path_param`` detaches.
The base draws are standard normals
(``Normal``, ``FoldNormal`` and the Gaussian heads), uniforms on [0, 1)
(``Bernoulli``, ``Uniform``, small-``n`` ``Binomial``) or uniforms on the
open interval (0, 1) (the Gumbel and logistic samplers of
``Categorical``, ``OnehotCategorical``, small-``n`` ``Multinomial`` and the
Concrete family, and ``Laplace``); a sampler built on torch's gamma,
beta, Poisson or binomial samplers takes no ``eps=``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.utils import (
    open_interval_standard_uniform,
)
from zhusuan_tpu_torch.framework.arith import unwrap

__all__ = ["Distribution"]


class Distribution:
    """Base class for probability distributions with batch semantics.

    Samples have shape ``([n_samples] +) batch_shape + value_shape``; the
    leading axis is present iff ``n_samples`` is not None. ``log_prob(given)``
    accepts values broadcastable to ``(... +) batch_shape + value_shape`` and
    returns shape ``(... +) batch_shape[:-group_ndims]``: the last
    ``group_ndims`` batch axes are grouped into a single event whose
    log-probabilities are summed.

    :param dtype: ``torch.dtype`` of samples.
    :param param_dtype: dtype of parameters (and of log_prob outputs).
    :param is_continuous: whether the distribution is continuous.
    :param is_reparameterized: whether sample gradients propagate into
        parameters via the reparameterization trick.
    :param use_path_derivative: if True, ``path_param`` detaches the
        parameters inside ``log_prob`` ("sticking the landing", Roeder et
        al. 2017).
    :param group_ndims: non-negative int; number of trailing batch axes
        folded into one event in ``log_prob``/``prob``.
    :param device: the parameters' device (samples are drawn there).
    """

    def __init__(
        self,
        dtype,
        param_dtype,
        is_continuous: bool,
        is_reparameterized: bool,
        use_path_derivative: bool = False,
        group_ndims: int = 0,
        device=None,
        **kwargs,
    ):
        if "group_event_ndims" in kwargs:
            raise ValueError(
                "The argument `group_event_ndims` has been deprecated. "
                "Please use `group_ndims` instead.")
        if not isinstance(group_ndims, (int, np.integer)):
            raise TypeError(
                "group_ndims must be a Python int; got {!r}.".format(
                    group_ndims))
        if group_ndims < 0:
            raise ValueError("group_ndims must be non-negative.")
        self._dtype = dtype
        self._param_dtype = param_dtype
        self._is_continuous = bool(is_continuous)
        self._is_reparameterized = bool(is_reparameterized)
        self._use_path_derivative = bool(use_path_derivative)
        self._group_ndims = int(group_ndims)
        self._device = torch.device("cpu") if device is None else device

    # -- metadata ------------------------------------------------------ #
    @property
    def dtype(self):
        """The sample dtype."""
        return self._dtype

    @property
    def param_dtype(self):
        """The parameter dtype."""
        return self._param_dtype

    @property
    def device(self) -> torch.device:
        """The parameters' device."""
        return self._device

    @property
    def is_continuous(self) -> bool:
        """Whether the distribution is continuous."""
        return self._is_continuous

    @property
    def is_reparameterized(self) -> bool:
        """Whether sample gradients flow into parameters."""
        return self._is_reparameterized

    @property
    def use_path_derivative(self) -> bool:
        """Whether log_prob detaches the parameters (STL estimator)."""
        return self._use_path_derivative

    @property
    def group_ndims(self) -> int:
        """Number of trailing batch axes grouped into one event."""
        return self._group_ndims

    def path_param(self, param):
        """``param`` detached when ``use_path_derivative`` is set
        (reference ``base.py:150-157``)."""
        if self._use_path_derivative:
            return param.detach()
        return param

    # -- shapes -------------------------------------------------------- #
    @property
    def batch_shape(self) -> Tuple[int, ...]:
        """Batch shape (broadcast of parameter shapes)."""
        return self._batch_shape()

    @property
    def value_shape(self) -> Tuple[int, ...]:
        """Per-sample value shape (``()`` for univariate)."""
        return self._value_shape()

    def get_batch_shape(self):
        return self.batch_shape

    def get_value_shape(self):
        return self.value_shape

    def _batch_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError()

    def _value_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError()

    # -- sampling ------------------------------------------------------ #
    def sample(self, generator: Optional[torch.Generator] = None,
               n_samples: Optional[int] = None, *, eps=None):
        """Draw samples.

        ``n_samples=None`` draws a single sample of shape
        ``batch_shape + value_shape``; an int draws
        ``[n_samples] + batch_shape + value_shape`` (reference
        ``base.py:237-263``).

        :param generator: a ``torch.Generator`` on :attr:`device`.
        :param eps: optional base draws that replace the generator's (a
            testing hook; see the module docstring for each class's): of
            the sample's shape, but for small-``n`` ``Binomial`` and
            ``Multinomial`` (an axis of ``n`` after the sample axis) and
            the categorical heads (an axis of ``K`` last).
        """
        if n_samples is None:
            if eps is not None:
                eps = torch.as_tensor(eps).unsqueeze(0)
            return self._sample(generator, 1, eps).squeeze(0)
        if not isinstance(n_samples, (int, np.integer)):
            raise TypeError(
                "n_samples must be None or a Python int; got {!r}.".format(
                    n_samples))
        if n_samples < 1:
            raise ValueError("n_samples must be >= 1.")
        return self._sample(generator, int(n_samples), eps)

    def _sample(self, generator, n_samples: int, eps):
        raise NotImplementedError()

    def _normals(self, generator, shape, eps):
        """Standard normals of ``shape`` in the sample dtype on
        :attr:`device`: ``eps`` when given (checked), else drawn from
        ``generator``."""
        return self._base_draws(torch.randn, self._dtype, generator, shape,
                                eps)

    def _uniforms(self, generator, shape, eps):
        """Uniforms on [0, 1) of ``shape`` in the parameter dtype on
        :attr:`device`: ``eps`` when given (checked), else drawn from
        ``generator``."""
        return self._base_draws(torch.rand, self._param_dtype, generator,
                                shape, eps)

    def _open_uniforms(self, generator, shape, eps):
        """Uniforms on the open interval (0, 1) of ``shape`` in the
        parameter dtype on :attr:`device` (see
        :func:`~zhusuan_tpu_torch.distributions.utils.
        open_interval_standard_uniform`): ``eps`` when given (checked),
        else drawn from ``generator``."""
        return self._base_draws(
            lambda shape, **kw: open_interval_standard_uniform(shape=shape,
                                                               **kw),
            self._param_dtype, generator, shape, eps)

    def _no_eps(self, eps, generator, sampler):
        """The check of a sampler that takes no base draws: ``eps`` must be
        None and ``generator`` given."""
        if eps is not None:
            raise ValueError(
                "{} draws from {}, which is not a transform of base draws: "
                "it takes no eps.".format(type(self).__name__, sampler))
        if generator is None:
            raise ValueError("Sampling needs a torch.Generator.")

    def _base_draws(self, draw, dtype, generator, shape, eps):
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=dtype, device=self._device)
            if tuple(eps.shape) != tuple(shape):
                raise ValueError("eps must have shape {}; got {}.".format(
                    tuple(shape), tuple(eps.shape)))
            return eps
        if generator is None:
            raise ValueError("Sampling needs a torch.Generator or eps.")
        return draw(shape, generator=generator, dtype=dtype,
                    device=self._device)

    # -- densities ----------------------------------------------------- #
    def _check_input_shape(self, given):
        given = unwrap(given)
        if not isinstance(given, torch.Tensor):
            given = torch.as_tensor(given, device=self._device)
        elif given.device.type == "cpu" and self._device.type != "cpu":
            # A value made on the host (an enumerated support, an index)
            # scores on the card beside the parameters.
            given = given.to(self._device)
        if self.is_continuous or not given.is_floating_point():
            given = given.to(self.dtype)
        else:
            # Float input to a discrete head scores in param_dtype, so soft
            # labels are not truncated to the integer sample dtype.
            given = given.to(self.param_dtype)
        static_sample_shape = tuple(self.batch_shape) + tuple(
            self.value_shape)
        try:
            torch.broadcast_shapes(tuple(given.shape), static_sample_shape)
        except RuntimeError:
            raise ValueError(
                "The given argument should be able to broadcast to "
                "match batch_shape + value_shape of the distribution. "
                "({} vs. {} + {})".format(tuple(given.shape),
                                          self.batch_shape, self.value_shape))
        return given

    def log_prob(self, given):
        """Log density/mass at ``given``; the last ``group_ndims`` axes are
        sum-reduced (reference ``base.py:291-303``)."""
        given = self._check_input_shape(given)
        return self._reduce_group(self._log_prob(given), torch.sum)

    def prob(self, given):
        """Density/mass at ``given``; trailing ``group_ndims`` axes
        product-reduced (reference ``base.py:305-320``)."""
        given = self._check_input_shape(given)
        return self._reduce_group(self._prob(given), torch.prod)

    def _reduce_group(self, x, reducer):
        if self._group_ndims == 0:
            return x
        if self._group_ndims > x.ndim:
            raise ValueError(
                "group_ndims ({}) exceeds the rank of the per-element "
                "log-probability ({}); it must not exceed the number of "
                "batch dimensions.".format(self._group_ndims, x.ndim))
        if reducer is torch.prod:  # torch.prod takes one dim at a time
            for _ in range(self._group_ndims):
                x = torch.prod(x, dim=-1)
            return x
        return reducer(x, dim=tuple(range(-self._group_ndims, 0)))

    def log_survival(self, given):
        """``log P(X > given)`` elementwise, trailing ``group_ndims`` axes
        sum-reduced (independent components: the joint survival is the
        product of marginals). Implemented by the heads used in survival
        models; so far :class:`Normal`."""
        given = self._check_input_shape(given)
        return self._reduce_group(self._log_survival(given), torch.sum)

    def _log_survival(self, given):
        raise NotImplementedError(
            "{} does not implement log_survival.".format(
                type(self).__name__))

    def _log_prob(self, given):
        raise NotImplementedError()

    def _prob(self, given):
        return torch.exp(self._log_prob(given))

    def __repr__(self):
        return "<{} batch_shape={} value_shape={} dtype={}>".format(
            type(self).__name__, self.batch_shape, self.value_shape,
            self.dtype)
