"""Univariate distributions.

Port of ``zhusuan_tpu/distributions/univariate.py``; so far
:class:`Normal` (parity: reference ``univariate.py:43-184``),
:class:`Bernoulli` (``univariate.py:334-406``) and :class:`Gamma`
(``univariate.py:662-750``). The other eleven names come with later slices
of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.utils import (
    as_param,
    assert_same_float_dtype,
    broadcast_shapes,
    param_device,
)
from zhusuan_tpu_torch.ops.checks import check_numerics

__all__ = ["Normal", "Bernoulli", "Gamma"]

_HALF_LOG_2PI = float(0.5 * (np.log(2.0) + np.log(np.pi)))


def _maybe_detach(params, is_reparameterized):
    if is_reparameterized:
        return params
    return tuple(p.detach() for p in params)


class Normal(Distribution):
    """Univariate Normal.

    Exactly one of ``std`` / ``logstd`` must be given (reference
    univariate.py:92-95); the ``_sentinel`` positional guard (univariate.py:89)
    makes legacy positional ``Normal(mean, logstd)`` calls fail loudly.

    Sampler: reparameterized ``eps * std + mean`` (univariate.py:161-172).
    Density: ``-0.5*log(2*pi) - logstd - 0.5*exp(-2*logstd)*(x-mean)**2``
    (univariate.py:174-181), with ``path_param`` on the parameters.
    """

    def __init__(
        self,
        mean=0.0,
        _sentinel=None,
        std=None,
        logstd=None,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        use_path_derivative: bool = False,
        check_numerics: bool = False,
        **kwargs,
    ):
        if _sentinel is not None:
            raise ValueError(
                "The order of `std` and `logstd` has changed from the legacy "
                "API; please use keyword arguments: Normal(mean, std=...) or "
                "Normal(mean, logstd=...).")
        if (std is None) == (logstd is None):
            raise ValueError(
                "Exactly one of `std` and `logstd` should be given.")
        device = param_device(mean, std, logstd)
        if std is not None:
            dtype = assert_same_float_dtype([(mean, "mean"), (std, "std")])
            self._std = as_param(std, dtype, device)
            self._logstd = torch.log(self._std)
        else:
            dtype = assert_same_float_dtype(
                [(mean, "mean"), (logstd, "logstd")])
            self._logstd = as_param(logstd, dtype, device)
            self._std = torch.exp(self._logstd)
        self._mean = as_param(mean, dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._mean.shape, self._std.shape)
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=True,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    mean = property(lambda self: self._mean, doc="The mean.")
    std = property(lambda self: self._std, doc="The standard deviation.")
    logstd = property(lambda self: self._logstd,
                      doc="The log standard deviation.")

    def _batch_shape(self):
        return broadcast_shapes(self._mean.shape, self._std.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        mean, std = _maybe_detach((self._mean, self._std),
                                  self.is_reparameterized)
        eps = self._normals(generator, (n_samples,) + self.batch_shape, eps)
        return eps * std + mean

    def _log_prob(self, given):
        mean = self.path_param(self._mean)
        logstd = self.path_param(self._logstd)
        precision = torch.exp(-2.0 * logstd)
        precision = check_numerics(precision, "precision",
                                   self._check_numerics)
        return -_HALF_LOG_2PI - logstd - 0.5 * precision * torch.square(
            given - mean)

    def _log_survival(self, given):
        # log P(X > x) = log ndtr(-z), stable deep into the tail.
        z = (given - self.path_param(self._mean)) * torch.exp(
            -self.path_param(self._logstd))
        return torch.special.log_ndtr(-z)


class Bernoulli(Distribution):
    """Bernoulli on {0, 1} parameterized by log-odds.

    Parity: reference ``univariate.py:334-406``. Sampler: ``u <
    sigmoid(logits)`` with ``u`` uniform on [0, 1) in the parameter dtype
    (univariate.py:386-396; ``eps=`` supplies ``u``); density: the negative
    sigmoid cross-entropy ``x * logits - softplus(logits)``
    (univariate.py:398-403). Not reparameterized.

    The softplus is ``logaddexp(logits, 0)``, as ``jax.nn.softplus`` is:
    ``torch.nn.functional.softplus`` returns ``x`` itself above its
    threshold of 20, an error of up to ``exp(-20)``.
    """

    def __init__(self, logits, dtype=torch.int32, group_ndims: int = 0,
                 **kwargs):
        device = param_device(logits)
        param_dtype = assert_same_float_dtype([(logits, "logits")])
        self._logits = as_param(logits, param_dtype, device)
        super().__init__(
            dtype=dtype,
            param_dtype=param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    logits = property(lambda self: self._logits,
                      doc="The log-odds of being 1.")

    def _batch_shape(self):
        return tuple(self._logits.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        p = torch.sigmoid(self._logits.detach())
        u = self._uniforms(generator, (n_samples,) + self.batch_shape, eps)
        return (u < p).to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        logits = self._logits
        return x * logits - torch.logaddexp(logits, torch.zeros_like(logits))


class Gamma(Distribution):
    """Gamma with shape ``alpha`` and rate ``beta``.

    Parity: reference ``univariate.py:662-750``; density
    ``alpha*log(beta) - lgamma(alpha) + (alpha-1)*log(x) - beta*x``
    (univariate.py:737-747).

    Sampler: torch's own gamma sampler (``torch._standard_gamma``, a
    rejection sampler), divided by the rate. It has no ``eps=`` hook: the
    draws are not a transform of standard normals, so the two packages'
    samples are compared by their moments. With
    ``is_reparameterized=True`` the sample carries torch's implicit
    reparameterization gradient with respect to ``alpha`` (as
    ``jax.random.gamma`` does in the JAX package), and the rate enters
    through the division; the default stays ``False`` as in the reference.
    """

    def __init__(self, alpha, beta, group_ndims: int = 0,
                 is_reparameterized: bool = False,
                 use_path_derivative: bool = False,
                 check_numerics: bool = False, **kwargs):
        device = param_device(alpha, beta)
        dtype = assert_same_float_dtype([(alpha, "alpha"), (beta, "beta")])
        self._alpha = as_param(alpha, dtype, device)
        self._beta = as_param(beta, dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._alpha.shape, self._beta.shape)
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=True,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    alpha = property(lambda self: self._alpha, doc="The shape.")
    beta = property(lambda self: self._beta, doc="The rate.")

    def _batch_shape(self):
        return broadcast_shapes(self._alpha.shape, self._beta.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        if eps is not None:
            raise ValueError(
                "Gamma draws from torch's gamma sampler, which is not a "
                "transform of standard normals: it takes no eps.")
        if generator is None:
            raise ValueError("Sampling needs a torch.Generator.")
        alpha, beta = _maybe_detach((self._alpha, self._beta),
                                    self.is_reparameterized)
        shape = (n_samples,) + self.batch_shape
        g = torch._standard_gamma(alpha.expand(shape), generator=generator)
        return g / beta

    def _log_prob(self, given):
        alpha = self.path_param(self._alpha)
        beta = self.path_param(self._beta)
        log_given = torch.log(given)
        log_beta = torch.log(beta)
        lgamma_alpha = torch.lgamma(alpha)
        if self._check_numerics:
            log_given = check_numerics(log_given, "log(given)")
            log_beta = check_numerics(log_beta, "log(beta)")
            lgamma_alpha = check_numerics(lgamma_alpha, "lgamma(alpha)")
        return (alpha * log_beta - lgamma_alpha + (alpha - 1) * log_given
                - beta * given)
