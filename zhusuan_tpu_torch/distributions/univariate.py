"""Univariate distributions.

Port of ``zhusuan_tpu/distributions/univariate.py`` (parity: reference
``zhusuan/distributions/univariate.py``, 14 classes, univariate.py:25-40):
``Normal``, ``FoldNormal``, ``Bernoulli``, ``Categorical`` (alias
``Discrete``), ``Uniform``, ``Gamma``, ``Beta``, ``Poisson``, ``Binomial``,
``InverseGamma``, ``Laplace`` and ``BinConcrete`` (alias
``BinGumbelSoftmax``), with the JAX package's arguments, checks and
messages. Each class cites the reference for its parameterization, sampler
and density.

Samplers take a ``torch.Generator`` on the parameters' device and, where
the draw is a transform of base draws, an ``eps=`` testing hook carrying
them (see :class:`~zhusuan_tpu_torch.distributions.base.Distribution`):
the JAX package's own draws fed through it give its samples exactly. The
Gamma-based draws (``Gamma``, ``Beta``, ``InverseGamma``), ``Poisson`` and
large-``n`` ``Binomial`` come from torch's samplers instead: the same laws
on another stream, held to the JAX package by their moments.
Non-reparameterized samplers draw from detached parameters, as the JAX
package's ``stop_gradient`` does.
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

__all__ = [
    "Normal",
    "FoldNormal",
    "Bernoulli",
    "Categorical",
    "Discrete",
    "Uniform",
    "Gamma",
    "Beta",
    "Poisson",
    "Binomial",
    "InverseGamma",
    "Laplace",
    "BinConcrete",
    "BinGumbelSoftmax",
]

_HALF_LOG_2PI = float(0.5 * (np.log(2.0) + np.log(np.pi)))
_LOG_2 = float(np.log(2.0))

# Above this trial count the Bernoulli-sum sampler (memory O(n)) gives way
# to torch's binomial sampler (the JAX package's split,
# univariate.py:615-617).
_DIRECT_SAMPLE_MAX_N = 64


def _maybe_detach(params, is_reparameterized):
    if is_reparameterized:
        return params
    return tuple(p.detach() for p in params)


def _softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``; ``torch.nn.functional.softplus`` returns ``x``
    above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _loc_scale_params(mean, std, logstd, _sentinel, legacy_msg):
    """The ``(mean, std, logstd, dtype, device)`` of a Normal-like head:
    exactly one of ``std`` / ``logstd`` (reference univariate.py:89-95)."""
    if _sentinel is not None:
        raise ValueError(legacy_msg)
    if (std is None) == (logstd is None):
        raise ValueError(
            "Exactly one of `std` and `logstd` should be given.")
    device = param_device(mean, std, logstd)
    if std is not None:
        dtype = assert_same_float_dtype([(mean, "mean"), (std, "std")])
        std = as_param(std, dtype, device)
        logstd = torch.log(std)
    else:
        dtype = assert_same_float_dtype([(mean, "mean"), (logstd, "logstd")])
        logstd = as_param(logstd, dtype, device)
        std = torch.exp(logstd)
    mean = as_param(mean, dtype, device)
    broadcast_shapes(mean.shape, std.shape)
    return mean, std, logstd, dtype, device


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
        self._mean, self._std, self._logstd, dtype, device = \
            _loc_scale_params(
                mean, std, logstd, _sentinel,
                "The order of `std` and `logstd` has changed from the legacy "
                "API; please use keyword arguments: Normal(mean, std=...) or "
                "Normal(mean, logstd=...).")
        self._check_numerics = check_numerics
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


class FoldNormal(Distribution):
    """Folded Normal: ``|X|`` for ``X ~ Normal(mean, std)``.

    Parity: reference ``univariate.py:187-331``. Density
    (univariate.py:319-328): the Normal log-density plus
    ``softplus(-2*mean*x/sigma^2)`` and a ``log(1[x >= 0])`` mask.

    As in the JAX package, the sampler returns ``|eps*std + mean|`` (the
    reference forgets the absolute value, univariate.py:306-317);
    ``fold_samples=False`` keeps the reference's behavior.
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
        fold_samples: bool = True,
        **kwargs,
    ):
        self._mean, self._std, self._logstd, dtype, device = \
            _loc_scale_params(
                mean, std, logstd, _sentinel,
                "Please use keyword arguments: FoldNormal(mean, std=...) or "
                "FoldNormal(mean, logstd=...).")
        self._check_numerics = check_numerics
        self._fold_samples = fold_samples
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

    mean = property(lambda self: self._mean)
    std = property(lambda self: self._std)
    logstd = property(lambda self: self._logstd)

    def _batch_shape(self):
        return broadcast_shapes(self._mean.shape, self._std.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        mean, std = _maybe_detach((self._mean, self._std),
                                  self.is_reparameterized)
        eps = self._normals(generator, (n_samples,) + self.batch_shape, eps)
        samples = eps * std + mean
        if self._fold_samples:
            samples = torch.abs(samples)
        return samples

    def _log_prob(self, given):
        mean = self.path_param(self._mean)
        logstd = self.path_param(self._logstd)
        precision = torch.exp(-2.0 * logstd)
        precision = check_numerics(precision, "precision",
                                   self._check_numerics)
        mask = torch.log((given >= 0.0).to(self.param_dtype))
        return (-_HALF_LOG_2PI - logstd
                - 0.5 * precision * torch.square(given - mean)
                + _softplus(-2.0 * mean * given * precision)
                + mask)


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


class Categorical(Distribution):
    """Categorical over {0, ..., K-1} parameterized by unnormalized logits.

    Parity: reference ``univariate.py:409-554``. ``logits`` has shape
    ``batch_shape + [K]``; samples are class indices of shape ``([n] +)
    batch_shape``. Sampler: ``argmax(logits + Gumbel)`` over the last axis,
    the Gumbels ``-log(-log u)`` of ``u`` uniform on (0, 1) of shape ``([n]
    +) batch_shape + [K]`` in the parameter dtype (``jax.random.
    categorical``'s construction; ``eps=`` supplies ``u``). Density: the
    log-softmax gathered at ``given``, broadcast against the batch, ``-inf``
    outside {0, ..., K-1} (univariate.py:496-548): the index is clamped
    before ``torch.gather`` (which raises out of range) and the result
    masked.
    """

    def __init__(self, logits, dtype=torch.int32, group_ndims: int = 0,
                 **kwargs):
        device = param_device(logits)
        param_dtype = assert_same_float_dtype([(logits, "logits")])
        self._logits = as_param(logits, param_dtype, device)
        if self._logits.ndim < 1:
            raise ValueError(
                "logits must be at least 1-D (..., n_categories).")
        self._n_categories = self._logits.shape[-1]
        super().__init__(
            dtype=dtype,
            param_dtype=param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    logits = property(lambda self: self._logits)
    n_categories = property(lambda self: self._n_categories)

    def _batch_shape(self):
        return tuple(self._logits.shape[:-1])

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        logits = self._logits.detach()
        u = self._open_uniforms(
            generator, (n_samples,) + self.batch_shape
            + (self._n_categories,), eps)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(gumbel + logits, dim=-1).to(self.dtype)

    def _log_prob(self, given):
        log_p = torch.log_softmax(self._logits, dim=-1)
        out_shape = broadcast_shapes(given.shape, self.batch_shape)
        given_b = given.expand(out_shape).to(torch.int64)
        log_p_b = log_p.expand(out_shape + (self._n_categories,))
        in_support = (given_b >= 0) & (given_b < self._n_categories)
        index = torch.clamp(given_b, 0, self._n_categories - 1)
        gathered = torch.gather(log_p_b, -1, index[..., None]).squeeze(-1)
        return torch.where(in_support, gathered,
                           torch.full_like(gathered, -float("inf")))


Discrete = Categorical


class Uniform(Distribution):
    """Continuous Uniform on [minval, maxval).

    Parity: reference ``univariate.py:557-659``. Reparameterized
    ``u * (maxval - minval) + minval`` with ``u`` uniform on [0, 1)
    (univariate.py:632-644; ``eps=`` supplies ``u``); density
    ``-log(maxval - minval)`` inside the support, ``-inf`` outside
    (univariate.py:646-659).
    """

    def __init__(
        self,
        minval=0.0,
        maxval=1.0,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        check_numerics: bool = False,
        **kwargs,
    ):
        device = param_device(minval, maxval)
        dtype = assert_same_float_dtype([(minval, "minval"),
                                         (maxval, "maxval")])
        self._minval = as_param(minval, dtype, device)
        self._maxval = as_param(maxval, dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._minval.shape, self._maxval.shape)
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=True,
            is_reparameterized=is_reparameterized,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    minval = property(lambda self: self._minval)
    maxval = property(lambda self: self._maxval)

    def _batch_shape(self):
        return broadcast_shapes(self._minval.shape, self._maxval.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        minval, maxval = _maybe_detach((self._minval, self._maxval),
                                       self.is_reparameterized)
        u = self._uniforms(generator, (n_samples,) + self.batch_shape, eps)
        return u * (maxval - minval) + minval

    def _log_prob(self, given):
        # -inf outside the support (log of the masked density).
        return torch.log(self._prob(given))

    def _prob(self, given):
        inv_range = 1.0 / (self._maxval - self._minval)
        inv_range = check_numerics(inv_range, "1 / (maxval - minval)",
                                   self._check_numerics)
        mask = (given >= self._minval) & (given < self._maxval)
        return inv_range * mask.to(self.param_dtype)


class _AlphaBeta(Distribution):
    """The shared constructor of the two-parameter positive heads
    (``Gamma``, ``Beta``, ``InverseGamma``): float ``alpha`` and ``beta`` of
    one dtype, broadcast together (reference univariate.py:700-731)."""

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

    alpha = property(lambda self: self._alpha)
    beta = property(lambda self: self._beta)

    def _batch_shape(self):
        return broadcast_shapes(self._alpha.shape, self._beta.shape)

    def _value_shape(self):
        return ()

    def _gammas(self, generator, alpha, shape):
        """Standard Gamma(alpha) draws of ``shape`` from torch's sampler,
        which carries the implicit reparameterization gradient with
        respect to ``alpha``."""
        return torch._standard_gamma(alpha.expand(shape), generator=generator)


class Gamma(_AlphaBeta):
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

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma sampler")
        alpha, beta = _maybe_detach((self._alpha, self._beta),
                                    self.is_reparameterized)
        shape = (n_samples,) + self.batch_shape
        g = self._gammas(generator, alpha, shape)
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


class Beta(_AlphaBeta):
    """Beta on (0, 1).

    Parity: reference ``univariate.py:753-854``; density
    ``(a-1) log x + (b-1) log(1-x) - lbeta(a, b)`` (univariate.py:833-851).
    With ``is_reparameterized=True`` the sampler is the two-Gamma
    construction ``Ga / (Ga + Gb)`` with torch's implicitly differentiable
    gamma sampler (the JAX package's, univariate.py:518-530, with
    ``jax.random.gamma``); otherwise torch's Dirichlet sampler on
    ``(alpha, beta)`` (the JAX package's ``jax.random.beta``). No ``eps=``.
    """

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma and Dirichlet samplers")
        shape = (n_samples,) + self.batch_shape
        if self.is_reparameterized:
            ga = self._gammas(generator, self._alpha, shape)
            gb = self._gammas(generator, self._beta, shape)
            return ga / (ga + gb)
        conc = torch.stack([self._alpha.detach().expand(shape),
                            self._beta.detach().expand(shape)], dim=-1)
        return torch._sample_dirichlet(conc, generator=generator)[..., 0]

    def _log_prob(self, given):
        alpha = self.path_param(self._alpha)
        beta = self.path_param(self._beta)
        log_given = torch.log(given)
        log_1_minus_given = torch.log1p(-given)
        lgamma_alpha = torch.lgamma(alpha)
        lgamma_beta = torch.lgamma(beta)
        lgamma_alpha_beta = torch.lgamma(alpha + beta)
        if self._check_numerics:
            log_given = check_numerics(log_given, "log(given)")
            log_1_minus_given = check_numerics(log_1_minus_given,
                                               "log(1 - given)")
        return ((alpha - 1) * log_given + (beta - 1) * log_1_minus_given
                - (lgamma_alpha + lgamma_beta - lgamma_alpha_beta))


class Poisson(Distribution):
    """Poisson with rate ``rate``.

    Parity: reference ``univariate.py:857-936``. Sampler: ``torch.poisson``
    (the JAX package's ``jax.random.poisson``; no ``eps=``); density
    ``x*log(rate) - rate - lgamma(x+1)`` (univariate.py:922-933).
    """

    def __init__(self, rate, dtype=torch.int32, group_ndims: int = 0,
                 check_numerics=False, **kwargs):
        device = param_device(rate)
        param_dtype = assert_same_float_dtype([(rate, "rate")])
        self._rate = as_param(rate, param_dtype, device)
        self._check_numerics = check_numerics
        super().__init__(
            dtype=dtype,
            param_dtype=param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    rate = property(lambda self: self._rate)

    def _batch_shape(self):
        return tuple(self._rate.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's Poisson sampler")
        shape = (n_samples,) + self.batch_shape
        rate = self._rate.detach().expand(shape)
        return torch.poisson(rate, generator=generator).to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        rate = self._rate
        log_rate = torch.log(rate)
        lgamma_x_plus_1 = torch.lgamma(x + 1.0)
        if self._check_numerics:
            log_rate = check_numerics(log_rate, "log(rate)")
            lgamma_x_plus_1 = check_numerics(lgamma_x_plus_1,
                                             "lgamma(given + 1)")
        return x * log_rate - rate - lgamma_x_plus_1


def _is_int_scalar_tensor(n):
    """Whether ``n`` is an array-like with an integer dtype (a torch tensor
    or a numpy array)."""
    if isinstance(n, torch.Tensor):
        return not (n.is_floating_point() or n.is_complex()
                    or n.dtype == torch.bool)
    return np.issubdtype(np.asarray(n).dtype, np.integer)


def _trial_count(n, allow_none, device):
    """The JAX package's ``n_experiments`` rules (univariate.py:646-673,
    multivariate.py:261-285): a positive Python int, or a 0-D integer
    array (tensor mode, positivity unchecked); None too where
    ``allow_none``."""
    if n is None and allow_none:
        return None
    if isinstance(n, (int, np.integer)) and not isinstance(n, bool):
        if n < 1:
            if allow_none:
                raise ValueError(
                    "n_experiments must be None or a positive int; got "
                    "{!r}.".format(n))
            raise ValueError(
                "n_experiments must be positive; got {!r}.".format(n))
        return int(n)
    if hasattr(n, "ndim") and hasattr(n, "dtype"):
        if n.ndim != 0:
            raise ValueError("n_experiments should be a scalar (0-D array).")
        if not _is_int_scalar_tensor(n):
            raise ValueError("n_experiments must be an int scalar.")
        return torch.as_tensor(n, device=device)
    if allow_none:
        raise ValueError(
            "n_experiments must be None, a positive int, or a 0-D int "
            "array; got {!r}.".format(n))
    raise ValueError(
        "n_experiments must be a positive int or a 0-D int array; got "
        "{!r}.".format(n))


class Binomial(Distribution):
    """Binomial: the number of successes in ``n_experiments`` Bernoulli
    trials with log-odds ``logits``.

    Parity: reference ``univariate.py:939-1067``. ``n_experiments`` is a
    positive Python int or a 0-D integer tensor (the reference's tensor
    mode, univariate.py:975-992); both score and sample. Sampler: for an
    int ``n <= 64``, the sum over ``n`` of ``u < sigmoid(logits)`` with
    ``u`` uniform on [0, 1) of shape ``(n_samples, n) + batch_shape`` (the
    JAX package's, univariate.py:686-692; ``eps=`` supplies ``u``);
    otherwise ``torch.binomial`` (the JAX package's ``jax.random.
    binomial``; no ``eps=``). Density ``log C(n, x) + x*logits -
    n*softplus(logits)`` (univariate.py:1047-1064).
    """

    def __init__(
        self,
        logits,
        n_experiments,
        dtype=torch.int32,
        group_ndims: int = 0,
        check_numerics=False,
        **kwargs,
    ):
        device = param_device(logits)
        param_dtype = assert_same_float_dtype([(logits, "logits")])
        self._logits = as_param(logits, param_dtype, device)
        self._n_experiments = _trial_count(n_experiments, False, device)
        self._check_numerics = check_numerics
        super().__init__(
            dtype=dtype,
            param_dtype=param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    logits = property(lambda self: self._logits)
    n_experiments = property(lambda self: self._n_experiments)

    def _batch_shape(self):
        return tuple(self._logits.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        p = torch.sigmoid(self._logits.detach())
        n = self._n_experiments
        if isinstance(n, int) and n <= _DIRECT_SAMPLE_MAX_N:
            u = self._uniforms(generator, (n_samples, n) + self.batch_shape,
                               eps)
            return torch.sum(u < p, dim=1).to(self.dtype)
        self._no_eps(eps, generator, "torch's binomial sampler")
        shape = (n_samples,) + self.batch_shape
        count = torch.as_tensor(n, dtype=self.param_dtype,
                                device=self.device)
        draw = torch.binomial(count.expand(shape).contiguous(),
                              p.expand(shape).contiguous(),
                              generator=generator)
        return draw.to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        logits = self._logits
        n = torch.as_tensor(self._n_experiments, dtype=self.param_dtype,
                            device=self.device)
        log_choose = (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                      - torch.lgamma(n - x + 1.0))
        if self._check_numerics:
            log_choose = check_numerics(log_choose, "log_choose")
        return log_choose + x * logits - n * _softplus(logits)


class InverseGamma(_AlphaBeta):
    """Inverse-Gamma: ``1/X`` for ``X ~ Gamma(alpha, beta)``.

    Parity: reference ``univariate.py:1070-1161``. Sampler ``beta / G``
    with ``G`` standard Gamma(alpha) from torch's sampler
    (univariate.py:1141-1144; no ``eps=``); density
    ``alpha*log(beta) - lgamma(alpha) - (alpha+1)*log(x) - beta/x``
    (univariate.py:1146-1158). ``is_reparameterized=True`` carries the
    implicit gradient through the Gamma draw, as :class:`Gamma` does.
    """

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma sampler")
        alpha, beta = _maybe_detach((self._alpha, self._beta),
                                    self.is_reparameterized)
        g = self._gammas(generator, alpha, (n_samples,) + self.batch_shape)
        return beta / g

    def _log_prob(self, given):
        alpha = self.path_param(self._alpha)
        beta = self.path_param(self._beta)
        log_given = torch.log(given)
        log_beta = torch.log(beta)
        lgamma_alpha = torch.lgamma(alpha)
        if self._check_numerics:
            log_given = check_numerics(log_given, "log(given)")
            log_beta = check_numerics(log_beta, "log(beta)")
        return (alpha * log_beta - lgamma_alpha - (alpha + 1) * log_given
                - beta / given)


class Laplace(Distribution):
    """Laplace with location ``loc`` and scale ``scale``.

    Parity: reference ``univariate.py:1164-1276``. Reparameterized
    inverse-CDF sampler ``loc - scale*sign(u)*log1p(-2|u|)`` with ``u + 0.5``
    uniform on (0, 1) (univariate.py:1246-1265; ``eps=`` supplies the
    open-interval uniform); density ``-log(2) - log(scale) - |x -
    loc|/scale`` (univariate.py:1267-1273).
    """

    def __init__(
        self,
        loc,
        scale,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        use_path_derivative: bool = False,
        check_numerics=False,
        **kwargs,
    ):
        device = param_device(loc, scale)
        dtype = assert_same_float_dtype([(loc, "loc"), (scale, "scale")])
        self._loc = as_param(loc, dtype, device)
        self._scale = as_param(scale, dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._loc.shape, self._scale.shape)
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

    loc = property(lambda self: self._loc)
    scale = property(lambda self: self._scale)

    def _batch_shape(self):
        return broadcast_shapes(self._loc.shape, self._scale.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        loc, scale = _maybe_detach((self._loc, self._scale),
                                   self.is_reparameterized)
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps) - 0.5
        return loc - scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))

    def _log_prob(self, given):
        loc = self.path_param(self._loc)
        scale = self.path_param(self._scale)
        log_scale = torch.log(scale)
        if self._check_numerics:
            log_scale = check_numerics(log_scale, "log(scale)")
        return -_LOG_2 - log_scale - torch.abs(given - loc) / scale


class BinConcrete(Distribution):
    """Binary Concrete (Maddison et al. 2017): a relaxed Bernoulli on
    (0, 1).

    Parity: reference ``univariate.py:1279-1405``. Sampler
    ``sigmoid((logits + L) / temperature)`` with the logistic noise ``L =
    log(u) - log1p(-u)`` of ``u`` uniform on (0, 1)
    (univariate.py:1363-1379; ``eps=`` supplies ``u``). Density
    (univariate.py:1381-1399): with ``t = temperature*logit(x) - logits``,
    ``log(temperature) - log(x) - log(1-x) + t - 2*softplus(t)``.
    Reparameterized; ``temperature`` is a scalar.
    """

    def __init__(
        self,
        temperature,
        logits,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        use_path_derivative: bool = False,
        check_numerics: bool = False,
        **kwargs,
    ):
        device = param_device(temperature, logits)
        dtype = assert_same_float_dtype(
            [(temperature, "temperature"), (logits, "logits")])
        self._temperature = as_param(temperature, dtype, device)
        self._logits = as_param(logits, dtype, device)
        if self._temperature.ndim != 0:
            raise ValueError("temperature must be a scalar.")
        self._check_numerics = check_numerics
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

    temperature = property(lambda self: self._temperature)
    logits = property(lambda self: self._logits)

    def _batch_shape(self):
        return tuple(self._logits.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        logits, temperature = _maybe_detach(
            (self._logits, self._temperature), self.is_reparameterized)
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps)
        logistic = torch.log(u) - torch.log1p(-u)
        return torch.sigmoid((logits + logistic) / temperature)

    def _log_prob(self, given):
        temperature = self.path_param(self._temperature)
        logits = self.path_param(self._logits)
        log_given = torch.log(given)
        log_1_minus_given = torch.log1p(-given)
        log_temperature = torch.log(temperature)
        if self._check_numerics:
            log_given = check_numerics(log_given, "log(given)")
            log_1_minus_given = check_numerics(log_1_minus_given,
                                               "log(1 - given)")
            log_temperature = check_numerics(log_temperature,
                                             "log(temperature)")
        t = temperature * (log_given - log_1_minus_given) - logits
        return (log_temperature - log_given - log_1_minus_given
                + t - 2.0 * _softplus(t))


BinGumbelSoftmax = BinConcrete
