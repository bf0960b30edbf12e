"""Heads beyond the reference zoo.

Port of ``zhusuan_tpu/distributions/extra.py``: ``StudentT``,
``Exponential``, ``Cauchy``, ``HalfCauchy``, ``LogNormal``,
``NegativeBinomial``, ``TruncatedNormal``, ``OrderedLogistic``,
``ZeroInflated``, ``Weibull``, ``RightCensored``, ``BetaBinomial`` and
``VonMises``, with the JAX package's arguments, checks, messages and
densities.

Samplers take a ``torch.Generator`` on the parameters' device. Where the
JAX sampler transforms base draws, ``eps=`` carries them (see
:class:`~zhusuan_tpu_torch.distributions.base.Distribution`): standard
normals for ``LogNormal``; uniforms on the open interval (0, 1) for
``Exponential``, ``Cauchy``, ``HalfCauchy``, ``Weibull`` and
``OrderedLogistic``; uniforms on [0, 1) for ``TruncatedNormal`` (the JAX
package's ``jax.random.truncated_normal`` maps one uniform through the
inverse CDF); the base's own draws for ``RightCensored``. ``StudentT``,
``NegativeBinomial`` and ``BetaBinomial`` draw from torch's gamma, Poisson,
beta and binomial samplers, ``ZeroInflated`` from its base's sampler and a
mask, and ``VonMises`` by rejection: they take no ``eps=`` and are held to
the JAX package by their moments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.univariate import (
    _maybe_detach,
    _softplus,
)
from zhusuan_tpu_torch.distributions.utils import (
    as_param,
    assert_same_float_dtype,
    broadcast_shapes,
    param_device,
)
from zhusuan_tpu_torch.ops.checks import check_numerics

__all__ = [
    "StudentT",
    "Exponential",
    "Cauchy",
    "HalfCauchy",
    "LogNormal",
    "NegativeBinomial",
    "TruncatedNormal",
    "OrderedLogistic",
    "ZeroInflated",
    "Weibull",
    "RightCensored",
    "BetaBinomial",
    "VonMises",
]

_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))
# Proposal rounds of VonMises's rejection loop: each round accepts with
# probability above 0.65 for any concentration (Best & Fisher 1979), so a
# draw is still pending after this many with probability below 1e-29.
_VON_MISES_ROUNDS = 64


def _log_sigmoid(x):
    return -_softplus(-x)


def _wrapper_batch(base, param_shape, param_name):
    """The batch shape of a wrapper whose parameter may extend the base's
    batch by leading axes only (JAX ``extra.py:51-68``): a parameter that
    widens a size-1 batch axis of the base would broadcast one base draw
    over the widened axis, so it raises."""
    base_b = tuple(base.batch_shape)
    full = tuple(broadcast_shapes(base_b, tuple(param_shape)))
    if base_b and full[len(full) - len(base_b):] != base_b:
        raise ValueError(
            "{} (shape {}) widens a size-1 batch axis of the base "
            "(batch shape {}); broadcast the BASE's parameters to the "
            "full batch shape instead so its samples stay "
            "independent.".format(param_name, tuple(param_shape), base_b))
    return full


def _sample_extended_batch(base, generator, n_samples, full_batch, eps=None):
    """Independent base draws of shape ``(n_samples,) + full_batch`` when
    ``full_batch`` extends ``base.batch_shape`` by leading axes: one draw a
    batch element, never a broadcast copy (JAX ``extra.py:71-79``). ``eps``
    of that shape carries the base's draws."""
    base_b = tuple(base.batch_shape)
    lead = tuple(full_batch)[: len(full_batch) - len(base_b)]
    k = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if eps is not None:
        eps = torch.as_tensor(eps)
        eps = eps.reshape((n_samples * k,) + tuple(eps.shape[1 + len(lead):]))
    draws = base.sample(generator, n_samples=n_samples * k, eps=eps)
    return draws.reshape((n_samples,) + lead + base_b)


class _LocScaleContinuous(Distribution):
    """Shared plumbing of the loc/scale continuous heads (JAX
    ``extra.py:82-126``)."""

    _loc_name = "loc"
    _scale_name = "scale"

    def __init__(self, loc, scale, group_ndims=0, is_reparameterized=True,
                 use_path_derivative=False, check_numerics=False,
                 dtype=None, device=None, **kwargs):
        # Subclasses with extra parameters (StudentT's df) pass the joint
        # dtype and device in; otherwise they follow loc and scale.
        if dtype is None:
            dtype = assert_same_float_dtype(
                [(loc, self._loc_name), (scale, self._scale_name)])
        if device is None:
            device = param_device(loc, scale)
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

    def _log_scale(self):
        return check_numerics(torch.log(self.path_param(self._scale)),
                              "log({})".format(self._scale_name),
                              self._check_numerics)


class StudentT(_LocScaleContinuous):
    """Student's t with ``df`` degrees of freedom, location and scale (JAX
    ``extra.py:129-205``).

    Sampler: ``loc + scale * t`` with ``t = z sqrt((df / 2) / g)``, ``z``
    standard normal and ``g ~ Gamma(df / 2)`` from torch's gamma sampler
    (the JAX package draws ``jax.random.t``; no ``eps=``). With
    ``reparameterize_df=True`` the gamma draw carries torch's implicit
    gradient into ``df``; otherwise ``df`` is detached. Density: the standard
    t density shifted and scaled.
    """

    def __init__(self, df, loc=0.0, scale=1.0, group_ndims=0,
                 is_reparameterized=True, reparameterize_df=False,
                 use_path_derivative=False, check_numerics=False, **kwargs):
        self._reparameterize_df = bool(reparameterize_df)
        dtype = assert_same_float_dtype(
            [(df, "df"), (loc, "loc"), (scale, "scale")])
        device = param_device(df, loc, scale)
        self._df = as_param(df, dtype, device)
        super().__init__(
            loc, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, dtype=dtype, device=device,
            **kwargs)

    df = property(lambda self: self._df)

    def _batch_shape(self):
        return broadcast_shapes(self._df.shape, self._loc.shape,
                                self._scale.shape)

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma sampler")
        df, loc, scale = _maybe_detach((self._df, self._loc, self._scale),
                                       self.is_reparameterized)
        if not (self.is_reparameterized and self._reparameterize_df):
            df = df.detach()
        shape = (n_samples,) + self.batch_shape
        half_df = (0.5 * df).expand(shape)
        z = torch.randn(shape, generator=generator, dtype=self.dtype,
                        device=self.device)
        g = torch._standard_gamma(half_df.contiguous(), generator=generator)
        return loc + scale * (z * torch.sqrt(half_df / g))

    def _log_prob(self, given):
        df = self.path_param(self._df)
        loc = self.path_param(self._loc)
        z = (given - loc) / self.path_param(self._scale)
        return (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                - 0.5 * torch.log(df * math.pi) - self._log_scale()
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))


class Exponential(Distribution):
    """Exponential with rate ``rate`` (JAX ``extra.py:208-259``).

    Sampler: ``-log(u) / rate``, ``u`` uniform on (0, 1) (``eps=``);
    density ``log(rate) - rate * x`` for ``x >= 0``, ``-inf`` below; the
    survival ``-rate * x``.
    """

    def __init__(self, rate, group_ndims=0, is_reparameterized=True,
                 use_path_derivative=False, check_numerics=False, **kwargs):
        dtype = assert_same_float_dtype([(rate, "rate")])
        device = param_device(rate)
        self._rate = as_param(rate, dtype, device)
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

    rate = property(lambda self: self._rate)

    def _batch_shape(self):
        return tuple(self._rate.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        (rate,) = _maybe_detach((self._rate,), self.is_reparameterized)
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps)
        return -torch.log(u) / rate

    def _log_prob(self, given):
        rate = self.path_param(self._rate)
        log_rate = check_numerics(torch.log(rate), "log(rate)",
                                  self._check_numerics)
        lp = log_rate - rate * given
        return torch.where(given >= 0, lp, torch.full_like(lp, -math.inf))

    def _log_survival(self, given):
        rate = self.path_param(self._rate)
        s = -rate * given
        return torch.where(given >= 0, s, torch.zeros_like(s))


class Cauchy(_LocScaleContinuous):
    """Cauchy with location and scale (JAX ``extra.py:262-284``).

    Sampler: ``loc + scale * tan(pi (u - 1/2))``, ``u`` uniform on (0, 1)
    (``eps=``); density ``-log(pi) - log(scale) - log1p(z^2)``.
    """

    def _sample(self, generator, n_samples, eps):
        loc, scale = _maybe_detach((self._loc, self._scale),
                                   self.is_reparameterized)
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps)
        return loc + scale * torch.tan(math.pi * (u - 0.5))

    def _log_prob(self, given):
        z = (given - self.path_param(self._loc)) / self.path_param(
            self._scale)
        return -math.log(math.pi) - self._log_scale() - torch.log1p(z * z)


class HalfCauchy(Distribution):
    """Half-Cauchy on ``[0, inf)`` with scale ``scale`` (JAX
    ``extra.py:287-336``).

    Sampler: ``scale * tan(pi u / 2)``, ``u`` uniform on (0, 1) (``eps=``);
    density ``log(2 / pi) - log(scale) - log1p(z^2)`` for ``x >= 0``.
    """

    def __init__(self, scale, group_ndims=0, is_reparameterized=True,
                 use_path_derivative=False, check_numerics=False, **kwargs):
        dtype = assert_same_float_dtype([(scale, "scale")])
        device = param_device(scale)
        self._scale = as_param(scale, dtype, device)
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

    scale = property(lambda self: self._scale)

    def _batch_shape(self):
        return tuple(self._scale.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        (scale,) = _maybe_detach((self._scale,), self.is_reparameterized)
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps)
        return scale * torch.tan(0.5 * math.pi * u)

    def _log_prob(self, given):
        scale = self.path_param(self._scale)
        log_scale = check_numerics(torch.log(scale), "log(scale)",
                                   self._check_numerics)
        z = given / scale
        lp = math.log(2.0 / math.pi) - log_scale - torch.log1p(z * z)
        return torch.where(given >= 0, lp, torch.full_like(lp, -math.inf))


class LogNormal(_LocScaleContinuous):
    """Log-normal ``exp(N(mean, scale))`` (JAX ``extra.py:339-382``).

    Sampler: ``exp(loc + scale * eps)``, ``eps`` standard normal
    (``eps=``); density ``N(log x; loc, scale) - log x`` for ``x > 0``;
    survival ``log_ndtr(-z)``.
    """

    _loc_name = "mean"

    def _sample(self, generator, n_samples, eps):
        loc, scale = _maybe_detach((self._loc, self._scale),
                                   self.is_reparameterized)
        eps = self._normals(generator, (n_samples,) + self.batch_shape, eps)
        return torch.exp(loc + scale * eps)

    def _safe_log(self, given):
        return torch.log(torch.clamp(given,
                                     min=torch.finfo(self.param_dtype).tiny))

    def _log_prob(self, given):
        loc = self.path_param(self._loc)
        scale = self.path_param(self._scale)
        log_x = self._safe_log(given)
        z = (log_x - loc) / scale
        lp = -_HALF_LOG_2PI - self._log_scale() - log_x - 0.5 * z * z
        return torch.where(given > 0, lp, torch.full_like(lp, -math.inf))

    def _log_survival(self, given):
        loc = self.path_param(self._loc)
        scale = self.path_param(self._scale)
        z = (self._safe_log(given) - loc) / scale
        s = torch.special.log_ndtr(-z)
        return torch.where(given > 0, s, torch.zeros_like(s))


class NegativeBinomial(Distribution):
    """Negative binomial: successes ``x`` before ``total_count`` failures,
    success probability ``sigmoid(logits)`` (JAX ``extra.py:385-460``)::

        pmf(x) = C(x + r - 1, x) (1 - p)^r p^x

    Sampler: the Gamma-Poisson mixture ``x ~ Poisson(lam)``, ``lam ~
    Gamma(r) e^{logits}``, from torch's samplers (no ``eps=``). Density
    through ``lgamma`` with softplus terms.
    """

    def __init__(self, logits, total_count, dtype=torch.int32,
                 group_ndims: int = 0, check_numerics=False, **kwargs):
        param_dtype = assert_same_float_dtype(
            [(logits, "logits"), (total_count, "total_count")])
        device = param_device(logits, total_count)
        self._logits = as_param(logits, param_dtype, device)
        self._total_count = as_param(total_count, param_dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._logits.shape, self._total_count.shape)
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
    total_count = property(lambda self: self._total_count)

    def _batch_shape(self):
        return broadcast_shapes(self._logits.shape, self._total_count.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma and Poisson samplers")
        shape = (n_samples,) + self.batch_shape
        r = self._total_count.detach().expand(shape).contiguous()
        lam = torch._standard_gamma(r, generator=generator) * torch.exp(
            self._logits.detach())
        return torch.poisson(lam, generator=generator).to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        r = self._total_count
        logits = self._logits
        log_comb = check_numerics(
            torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0),
            "log_combination", self._check_numerics)
        return log_comb + r * (-_softplus(logits)) + x * (-_softplus(-logits))


class TruncatedNormal(_LocScaleContinuous):
    """Normal truncated to ``[low, high]`` (JAX ``extra.py:463-548``).

    Sampler: ``clip(loc + scale * tn, low, high)`` with ``tn`` the
    inverse-CDF draw of ``jax.random.truncated_normal`` at the standardized
    bounds ``a``, ``b``: ``u = max(erf(a / sqrt 2), u0 (erf(b / sqrt 2) -
    erf(a / sqrt 2)) + erf(a / sqrt 2))`` for ``u0`` uniform on [0, 1)
    (``eps=``), ``sqrt 2 erfinv(u)`` clipped to the open interval.
    Density: the standard normal's minus ``log(Phi(b) - Phi(a))`` (from
    ``log_ndtr``, reflected into the well-conditioned tail), ``-inf``
    outside the support.
    """

    def __init__(self, loc, scale, low, high, group_ndims=0,
                 is_reparameterized=True, use_path_derivative=False,
                 check_numerics=False, **kwargs):
        dtype = assert_same_float_dtype(
            [(loc, "loc"), (scale, "scale"), (low, "low"), (high, "high")])
        device = param_device(loc, scale, low, high)
        self._low = as_param(low, dtype, device)
        self._high = as_param(high, dtype, device)
        super().__init__(
            loc, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, dtype=dtype, device=device,
            **kwargs)
        broadcast_shapes(self._low.shape, self._high.shape, self.batch_shape)

    low = property(lambda self: self._low)
    high = property(lambda self: self._high)

    def _batch_shape(self):
        return broadcast_shapes(self._loc.shape, self._scale.shape,
                                self._low.shape, self._high.shape)

    def _sample(self, generator, n_samples, eps):
        loc, scale, low, high = _maybe_detach(
            (self._loc, self._scale, self._low, self._high),
            self.is_reparameterized)
        shape = (n_samples,) + self.batch_shape
        a = ((low - loc) / scale).expand(shape)
        b = ((high - loc) / scale).expand(shape)
        sqrt2 = math.sqrt(2.0)
        ea, eb = torch.erf(a / sqrt2), torch.erf(b / sqrt2)
        u0 = self._uniforms(generator, shape, eps)
        u = torch.maximum(ea, u0 * (eb - ea) + ea)
        tn = sqrt2 * torch.erfinv(u)
        inf = torch.full_like(tn, math.inf)
        tn = torch.minimum(
            torch.maximum(tn, torch.nextafter(a.detach(), inf)),
            torch.nextafter(b.detach(), -inf))
        return torch.minimum(torch.maximum(loc + scale * tn, low), high)

    @staticmethod
    def _log_norm_const(a, b):
        """``log(Phi(b) - Phi(a))``, stable in both tails: an interval in
        the right tail is reflected, so the larger mass anchors the
        ``log1p(-exp(.))``."""
        reflect = a > -b
        lo = torch.where(reflect, -b, a)
        hi = torch.where(reflect, -a, b)
        big = torch.special.log_ndtr(hi)
        small = torch.special.log_ndtr(lo)
        return big + torch.log1p(-torch.exp(small - big))

    def _log_prob(self, given):
        loc = self.path_param(self._loc)
        scale = self.path_param(self._scale)
        low = self.path_param(self._low)
        high = self.path_param(self._high)
        z = (given - loc) / scale
        a = (low - loc) / scale
        b = (high - loc) / scale
        log_norm = check_numerics(self._log_norm_const(a, b),
                                  "log_normalizer", self._check_numerics)
        lp = -_HALF_LOG_2PI - 0.5 * z * z - self._log_scale() - log_norm
        in_support = (given >= low) & (given <= high)
        return torch.where(in_support, lp, torch.full_like(lp, -math.inf))


class OrderedLogistic(Distribution):
    """Cumulative-logit (proportional-odds) categorical head (JAX
    ``extra.py:551-660``)::

        P(y <= k) = sigmoid(c_k - eta),   k = 0..K-2

    The adjacent CDF differences are taken in log space,
    ``log_sigmoid(a) + log_sigmoid(-b) + log(-expm1(min(b - a, -1e-12)))``
    for ``a = c_y - eta``, ``b = c_{y-1} - eta`` (``c_{-1}``, ``c_{K-1}``
    padded with ``-+finfo.max / 2``), NaN where the cutpoints are not
    increasing. Sampler: ``#{k: eta + log(u) - log1p(-u) > c_k}``, ``u``
    uniform on (0, 1) in the parameter dtype (``eps=``).

    :param eta: linear predictor.
    :param cutpoints: ``[..., K-1]`` increasing thresholds.
    """

    def __init__(self, eta, cutpoints, dtype=torch.int32,
                 group_ndims: int = 0, **kwargs):
        param_dtype = assert_same_float_dtype(
            [(eta, "eta"), (cutpoints, "cutpoints")])
        device = param_device(eta, cutpoints)
        self._eta = as_param(eta, param_dtype, device)
        self._cutpoints = as_param(cutpoints, param_dtype, device)
        if self._cutpoints.ndim < 1 or self._cutpoints.shape[-1] < 1:
            raise ValueError(
                "cutpoints must have a trailing axis of >= 1 thresholds.")
        broadcast_shapes(self._eta.shape, self._cutpoints.shape[:-1])
        super().__init__(
            dtype=dtype,
            param_dtype=param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    eta = property(lambda self: self._eta)
    cutpoints = property(lambda self: self._cutpoints)

    @property
    def n_categories(self):
        return self._cutpoints.shape[-1] + 1

    def _batch_shape(self):
        return broadcast_shapes(self._eta.shape, self._cutpoints.shape[:-1])

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        eta = self._eta.detach()
        cuts = self._cutpoints.detach()
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps)
        latent = eta + torch.log(u) - torch.log1p(-u)
        return torch.sum(latent[..., None] > cuts, dim=-1).to(self.dtype)

    def _log_prob(self, given):
        eta = self._eta
        cuts = self._cutpoints.expand(broadcast_shapes(
            tuple(eta.shape) + (1,), self._cutpoints.shape))
        big = torch.finfo(self.param_dtype).max / 2
        pad = torch.ones_like(cuts[..., :1])
        padded = torch.cat([-big * pad, cuts, big * pad], dim=-1)
        idx = given.expand(broadcast_shapes(given.shape, eta.shape)).to(
            torch.int64)
        table = padded.expand(tuple(idx.shape) + padded.shape[-1:])
        hi = torch.gather(table, -1, idx[..., None] + 1)[..., 0]
        lo = torch.gather(table, -1, idx[..., None])[..., 0]
        a, b = hi - eta, lo - eta
        lp = (_log_sigmoid(a) + _log_sigmoid(-b)
              + torch.log(-torch.expm1(torch.clamp(b - a, max=-1e-12))))
        # Inverted cutpoints (b >= a) would be clamped silently by the
        # stable form: surface the caller's ordering violation.
        return torch.where(b < a, lp, torch.full_like(lp, math.nan))


class ZeroInflated(Distribution):
    """Zero-inflated wrapper over a scalar count distribution (JAX
    ``extra.py:663-754``): with ``pi = sigmoid(pi_logits)``,
    ``pmf(x) = pi 1[x = 0] + (1 - pi) base.pmf(x)``.

    Sampler: one independent base draw a batch element and a structural-zero
    mask ``u < pi`` (no ``eps=``).

    :param base: a discrete scalar-event Distribution with
        ``group_ndims == 0``.
    :param pi_logits: log-odds of a structural zero.
    """

    def __init__(self, base: Distribution, pi_logits,
                 group_ndims: int = 0, **kwargs):
        if not isinstance(base, Distribution):
            raise TypeError(
                "base must be a Distribution; got {!r}.".format(type(base)))
        if base.is_continuous:
            raise ValueError(
                "ZeroInflated wraps DISCRETE count distributions; for "
                "continuous zero-inflation use a Mixture with an "
                "Implicit point mass.")
        if base.value_shape != ():
            raise ValueError(
                "base must have a scalar event (value_shape ()); got "
                "{}.".format(base.value_shape))
        if base.group_ndims != 0:
            raise ValueError(
                "base.group_ndims must be 0 (apply group_ndims on the "
                "ZeroInflated wrapper instead).")
        self._base = base
        self._pi_logits = as_param(pi_logits, base.param_dtype, base.device)
        _wrapper_batch(base, self._pi_logits.shape, "pi_logits")
        super().__init__(
            dtype=base.dtype,
            param_dtype=base.param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=base.device,
            **kwargs,
        )

    base = property(lambda self: self._base)
    pi_logits = property(lambda self: self._pi_logits)

    def _batch_shape(self):
        return broadcast_shapes(self._base.batch_shape,
                                self._pi_logits.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "its base's sampler and a mask")
        shape = (n_samples,) + self.batch_shape
        draws = _sample_extended_batch(self._base, generator, n_samples,
                                       self.batch_shape)
        pi = torch.sigmoid(self._pi_logits.detach())
        u = torch.rand(shape, generator=generator, dtype=self.param_dtype,
                       device=self.device)
        return torch.where(u < pi, torch.zeros_like(draws), draws).to(
            self.dtype)

    def _log_prob(self, given):
        log_pi = -_softplus(-self._pi_logits)
        log_1mpi = -_softplus(self._pi_logits)
        lp_base = self._base.log_prob(given)
        lp_zero = self._base.log_prob(torch.zeros_like(given))
        return torch.where(given == 0,
                           torch.logaddexp(log_pi, log_1mpi + lp_zero),
                           log_1mpi + lp_base)


class Weibull(Distribution):
    """Weibull with concentration ``k`` and scale ``lam`` (JAX
    ``extra.py:757-841``)::

        pdf(x) = (k / lam) (x / lam)^{k-1} exp(-(x / lam)^k)

    Sampler: ``lam (-log u)^{1/k}``, ``u`` uniform on (0, 1) (``eps=``);
    survival ``-(x / lam)^k``, for :class:`RightCensored`.
    """

    def __init__(self, concentration, scale, group_ndims=0,
                 is_reparameterized=True, use_path_derivative=False,
                 check_numerics=False, **kwargs):
        dtype = assert_same_float_dtype(
            [(concentration, "concentration"), (scale, "scale")])
        device = param_device(concentration, scale)
        self._concentration = as_param(concentration, dtype, device)
        self._scale = as_param(scale, dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._concentration.shape, self._scale.shape)
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

    concentration = property(lambda self: self._concentration)
    scale = property(lambda self: self._scale)

    def _batch_shape(self):
        return broadcast_shapes(self._concentration.shape, self._scale.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        k, lam = _maybe_detach((self._concentration, self._scale),
                               self.is_reparameterized)
        u = self._open_uniforms(generator, (n_samples,) + self.batch_shape,
                                eps)
        return lam * torch.pow(-torch.log(u), 1.0 / k)

    def _safe_log(self, given):
        return torch.log(torch.clamp(given,
                                     min=torch.finfo(self.param_dtype).tiny))

    def _log_prob(self, given):
        k = self.path_param(self._concentration)
        lam = self.path_param(self._scale)
        log_z = self._safe_log(given) - torch.log(lam)
        log_k = check_numerics(torch.log(k), "log(concentration)",
                               self._check_numerics)
        lp = log_k - torch.log(lam) + (k - 1.0) * log_z - torch.exp(
            k * log_z)
        return torch.where(given > 0, lp, torch.full_like(lp, -math.inf))

    def _log_survival(self, given):
        k = self.path_param(self._concentration)
        lam = self.path_param(self._scale)
        s = -torch.exp(k * (self._safe_log(given) - torch.log(lam)))
        return torch.where(given > 0, s, torch.zeros_like(s))


class RightCensored(Distribution):
    """Right-censoring wrapper: the law of ``y = min(T, upper)`` for
    ``T ~ base`` (JAX ``extra.py:844-908``): ``base.log_prob(y)`` where
    ``y < upper`` (an observed event), ``base.log_survival(upper)`` where
    censored. Sampler: independent base draws (``eps=`` carries the base's,
    of the sample's shape) clipped at ``upper``.

    :param base: a scalar-event Distribution with ``group_ndims == 0`` that
        implements ``log_survival``.
    :param upper: censor times.
    """

    def __init__(self, base: Distribution, upper, group_ndims=0, **kwargs):
        if not isinstance(base, Distribution):
            raise TypeError(
                "base must be a Distribution; got {!r}.".format(type(base)))
        if base.value_shape != () or base.group_ndims != 0:
            raise ValueError(
                "base must have a scalar event and group_ndims == 0 "
                "(apply group_ndims on the RightCensored wrapper).")
        self._base = base
        self._upper = as_param(upper, base.param_dtype, base.device)
        _wrapper_batch(base, self._upper.shape, "upper")
        super().__init__(
            dtype=base.dtype,
            param_dtype=base.param_dtype,
            is_continuous=base.is_continuous,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=base.device,
            **kwargs,
        )

    base = property(lambda self: self._base)
    upper = property(lambda self: self._upper)

    def _batch_shape(self):
        return broadcast_shapes(self._base.batch_shape, self._upper.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        draws = _sample_extended_batch(self._base, generator, n_samples,
                                       self.batch_shape, eps)
        return torch.minimum(draws, self._upper)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        lp_event = self._base.log_prob(x)
        lp_censored = self._base.log_survival(self._upper)
        return torch.where(x < self._upper, lp_event, lp_censored)


class BetaBinomial(Distribution):
    """Beta-binomial: successes in ``n`` trials with a Beta(``alpha``,
    ``beta``) success probability (JAX ``extra.py:911-998``)::

        pmf(x) = C(n, x) B(x + a, n - x + b) / B(a, b)

    Sampler: ``p ~ Beta(a, b)``, ``x ~ Binomial(n, p)`` from torch's
    samplers (no ``eps=``).

    :param n_experiments: positive Python int trial count.
    """

    def __init__(self, n_experiments, alpha, beta, dtype=torch.int32,
                 group_ndims: int = 0, check_numerics=False, **kwargs):
        param_dtype = assert_same_float_dtype(
            [(alpha, "alpha"), (beta, "beta")])
        if not isinstance(n_experiments, (int, np.integer)) or \
                isinstance(n_experiments, bool) or n_experiments < 1:
            raise ValueError(
                "n_experiments must be a positive int; got {!r}.".format(
                    n_experiments))
        device = param_device(alpha, beta)
        self._n_experiments = int(n_experiments)
        self._alpha = as_param(alpha, param_dtype, device)
        self._beta = as_param(beta, param_dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._alpha.shape, self._beta.shape)
        super().__init__(
            dtype=dtype,
            param_dtype=param_dtype,
            is_continuous=False,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    n_experiments = property(lambda self: self._n_experiments)
    alpha = property(lambda self: self._alpha)
    beta = property(lambda self: self._beta)

    def _batch_shape(self):
        return broadcast_shapes(self._alpha.shape, self._beta.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's beta and binomial samplers")
        shape = (n_samples,) + self.batch_shape
        conc = torch.stack([self._alpha.detach().expand(shape),
                            self._beta.detach().expand(shape)], dim=-1)
        p = torch._sample_dirichlet(conc, generator=generator)[..., 0]
        count = torch.full(shape, float(self._n_experiments),
                           dtype=self.param_dtype, device=self.device)
        return torch.binomial(count, p, generator=generator).to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        a, b = self._alpha, self._beta
        n = float(self._n_experiments)

        def lbeta(u, v):
            return torch.lgamma(u) + torch.lgamma(v) - torch.lgamma(u + v)

        log_comb = check_numerics(
            math.lgamma(n + 1.0) - torch.lgamma(x + 1.0)
            - torch.lgamma(n - x + 1.0),
            "log_combination", self._check_numerics)
        return log_comb + lbeta(x + a, n - x + b) - lbeta(a, b)


class VonMises(Distribution):
    """Von Mises (circular normal) on ``(-pi, pi]`` (JAX
    ``extra.py:1001-1099``)::

        pdf(x) = exp(kappa cos(x - loc)) / (2 pi I0(kappa))

    Sampler: Best & Fisher's (1979) wrapped-Cauchy rejection, as the JAX
    package's masked ``while_loop`` but over a fixed number of proposal
    rounds on the device (each accepts with probability above 0.65, so a
    draw is still pending after the last with probability below 1e-29),
    with no host read; detached, no ``eps=``.
    """

    def __init__(self, loc, concentration, group_ndims=0,
                 check_numerics=False, **kwargs):
        dtype = assert_same_float_dtype(
            [(loc, "loc"), (concentration, "concentration")])
        device = param_device(loc, concentration)
        self._loc = as_param(loc, dtype, device)
        self._concentration = as_param(concentration, dtype, device)
        self._check_numerics = check_numerics
        broadcast_shapes(self._loc.shape, self._concentration.shape)
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=True,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    loc = property(lambda self: self._loc)
    concentration = property(lambda self: self._concentration)

    def _batch_shape(self):
        return broadcast_shapes(self._loc.shape, self._concentration.shape)

    def _value_shape(self):
        return ()

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "a rejection sampler")
        loc = self._loc.detach()
        shape = (n_samples,) + self.batch_shape
        kappa = self._concentration.detach().expand(shape)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
        r = (1.0 + rho * rho) / (2.0 * rho)
        draw = torch.zeros(shape, dtype=self.param_dtype, device=self.device)
        accepted = torch.zeros(shape, dtype=torch.bool, device=self.device)
        for _ in range(_VON_MISES_ROUNDS):
            u1, u2, u3 = (self._open_uniforms(generator, shape, None)
                          for _ in range(3))
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = kappa * (r - f)
            ok = (c * (2.0 - c) - u2 > 0.0) | (
                torch.log(c / u2) + 1.0 - c >= 0.0)
            angle = torch.where(u3 > 0.5, torch.arccos(f), -torch.arccos(f))
            draw = torch.where(ok & ~accepted, angle, draw)
            accepted = accepted | ok
        out = draw + loc
        return out - 2.0 * math.pi * torch.round(out / (2.0 * math.pi))

    def _log_prob(self, given):
        loc = self.path_param(self._loc)
        kappa = self.path_param(self._concentration)
        log_i0 = check_numerics(
            torch.log(torch.special.i0e(kappa)) + kappa, "log(I0(kappa))",
            self._check_numerics)
        return kappa * torch.cos(given - loc) - math.log(2.0 * math.pi) \
            - log_i0
