"""Multivariate distributions.

Port of ``zhusuan_tpu/distributions/multivariate.py`` (parity: reference
``zhusuan/distributions/multivariate.py``, 12 classes,
multivariate.py:25-38): ``MultivariateNormalCholesky``, ``Multinomial``,
``UnnormalizedMultinomial`` (alias ``BagofCategoricals``),
``OnehotCategorical`` (alias ``OnehotDiscrete``), ``Dirichlet``,
``ExpConcrete`` (alias ``ExpGumbelSoftmax``), ``Concrete`` (alias
``GumbelSoftmax``), ``MatrixVariateNormalCholesky`` and the JAX package's
``MultivariateStudentTCholesky``, with its arguments, checks and messages.

``eps=`` carries the base draws where the sampler is a transform of them:
the standard normals of the Gaussian heads and the open-interval uniforms
behind the Gumbels of the categorical heads and the Concrete family (see
:class:`~zhusuan_tpu_torch.distributions.univariate.Categorical`). The
Dirichlet, large-``n`` Multinomial and Student-t draws come from torch's
gamma, Dirichlet and binomial samplers and take no ``eps=``.
"""

from __future__ import annotations

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.univariate import (
    _DIRECT_SAMPLE_MAX_N,
    _trial_count,
)
from zhusuan_tpu_torch.distributions.utils import (
    as_param,
    assert_same_float_dtype,
    broadcast_shapes,
    log_combination,
    param_device,
)
from zhusuan_tpu_torch.ops.checks import check_numerics

__all__ = [
    "MultivariateNormalCholesky",
    "Multinomial",
    "UnnormalizedMultinomial",
    "BagofCategoricals",
    "OnehotCategorical",
    "OnehotDiscrete",
    "Dirichlet",
    "ExpConcrete",
    "ExpGumbelSoftmax",
    "Concrete",
    "GumbelSoftmax",
    "MatrixVariateNormalCholesky",
    "MultivariateStudentTCholesky",
]

_LOG_2PI = float(np.log(2.0) + np.log(np.pi))


class MultivariateNormalCholesky(Distribution):
    """Multivariate Normal parameterized by its mean and the Cholesky factor
    of its covariance.

    ``mean``: ``[..., d]``; ``cov_tril``: ``[..., d, d]`` lower-triangular.
    Sampler ``mean + L @ eps`` (reference multivariate.py:145-167); density
    by a batched triangular solve with ``logdet = 2*sum(log(diag(L)))``
    (multivariate.py:169-189). Reparameterized.

    Own-sample fast path: ``sample()`` keeps (sample, eps) on the instance,
    so ``log_prob`` of the distribution's own latest sample (object
    identity) skips the solve; see :meth:`log_prob`. A second ``sample()``
    replaces the first, whose scoring then takes the solve path, which is
    exact too.

    :param cov_tril_inv: optional precomputed ``L^{-1}`` of ``cov_tril``'s
        shape (e.g. from :func:`zhusuan_tpu_torch.ops.cholesky_inverse`).
        ``log_prob`` then whitens by a matmul instead of a triangular solve;
        the caller is responsible for it inverting ``cov_tril``.
    """

    def __init__(
        self,
        mean,
        cov_tril,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        use_path_derivative: bool = False,
        check_numerics: bool = False,
        cov_tril_inv=None,
        **kwargs,
    ):
        dtype = assert_same_float_dtype(
            [(mean, "mean"), (cov_tril, "cov_tril")])
        device = param_device(mean, cov_tril)
        self._mean = as_param(mean, dtype, device)
        self._cov_tril = as_param(cov_tril, dtype, device)
        if self._mean.ndim < 1:
            raise ValueError("mean must be at least 1-D ([..., d]).")
        if self._cov_tril.ndim < 2:
            raise ValueError("cov_tril must be at least 2-D ([..., d, d]).")
        d = self._mean.shape[-1]
        if tuple(self._cov_tril.shape[-2:]) != (d, d):
            raise ValueError(
                "cov_tril trailing dims must be [d, d] with d matching mean "
                "({} vs. {}).".format(tuple(self._cov_tril.shape),
                                      tuple(self._mean.shape)))
        self._n_dim = d
        self._check_numerics = check_numerics
        if cov_tril_inv is not None:
            cov_tril_inv = as_param(cov_tril_inv, dtype, device)
            if cov_tril_inv.shape != self._cov_tril.shape:
                raise ValueError(
                    "cov_tril_inv must match cov_tril's shape ({} vs. "
                    "{}).".format(tuple(cov_tril_inv.shape),
                                  tuple(self._cov_tril.shape)))
        self._cov_tril_inv = cov_tril_inv
        self._own_sample = None
        self._own_eps = None
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
    cov_tril = property(lambda self: self._cov_tril)

    def _batch_shape(self):
        return broadcast_shapes(self._mean.shape[:-1],
                                self._cov_tril.shape[:-2])

    def _value_shape(self):
        return (self._n_dim,)

    def _sample(self, generator, n_samples, eps):
        mean, cov_tril = self._mean, self._cov_tril
        if not self.is_reparameterized:
            mean, cov_tril = mean.detach(), cov_tril.detach()
        shape = (n_samples,) + self.batch_shape + (self._n_dim,)
        eps = self._normals(generator, shape, eps)
        self._pending_eps = eps
        return mean + torch.matmul(cov_tril, eps[..., None]).squeeze(-1)

    def sample(self, generator=None, n_samples=None, *, eps=None):
        self._pending_eps = None
        out = super().sample(generator, n_samples, eps=eps)
        own_eps = self._pending_eps
        if own_eps is not None and n_samples is None:
            own_eps = own_eps.squeeze(0)
        # Keep (sample, its white noise), so that scoring the
        # distribution's OWN reparameterized sample -- the q-entropy term of
        # every variational objective -- skips the triangular solve.
        self._own_sample = out
        self._own_eps = own_eps
        return out

    def log_prob(self, given):
        """Log density. When ``given`` IS this object's own reparameterized
        sample (object identity), ``L^{-1}(z - mean) == eps`` scores it as
        ``-||eps||^2/2 - sum(log diag L) - d/2 log 2pi`` with no solve.
        Values agree with the solve path; gradients agree on the
        lower-triangular manifold, and the strictly-upper entries of
        ``cov_tril`` (which the density ignores) get 0 here where the solve
        path passes on a sampling-path term. Observed values,
        non-reparameterized samples and ``use_path_derivative`` take the
        solve path."""
        if (given is self._own_sample and self._own_eps is not None
                and self.is_reparameterized
                and not self.use_path_derivative):
            log_diag = torch.log(torch.diagonal(self._cov_tril, dim1=-2,
                                                dim2=-1))
            log_diag = check_numerics(log_diag, "log(diag(cov_tril))",
                                      self._check_numerics)
            log_det = 2.0 * torch.sum(log_diag, dim=-1)
            maha = torch.sum(self._own_eps * self._own_eps, dim=-1)
            lp = -0.5 * (self._n_dim * _LOG_2PI + maha + log_det)
            return self._reduce_group(lp, torch.sum)
        return super().log_prob(given)

    def _log_prob(self, given):
        mean = self.path_param(self._mean)
        cov_tril = self.path_param(self._cov_tril)
        log_diag = torch.log(torch.diagonal(cov_tril, dim1=-2, dim2=-1))
        log_diag = check_numerics(log_diag, "log(diag(cov_tril))",
                                  self._check_numerics)
        log_det = 2.0 * torch.sum(log_diag, dim=-1)
        y = given - mean
        target_shape = broadcast_shapes(
            y.shape, self.batch_shape + (self._n_dim,))
        y = y.expand(target_shape)
        if self._cov_tril_inv is not None:
            # Whiten by the precomputed inverse factor: one matmul (float32
            # matmuls run in full float32 on the card unless TF32 is
            # enabled, which the port never does).
            linv = self.path_param(self._cov_tril_inv)
            z = torch.matmul(linv, y[..., None])
        else:
            z = torch.linalg.solve_triangular(
                cov_tril.expand(target_shape[:-1]
                                + (self._n_dim, self._n_dim)),
                y[..., None], upper=False)
        maha = torch.sum(torch.square(z.squeeze(-1)), dim=-1)
        return -0.5 * (self._n_dim * _LOG_2PI + maha + log_det)


class _Logits(Distribution):
    """The shared constructor of the heads over ``K`` categories given by
    ``logits`` of shape ``batch_shape + [K]`` (value shape ``[K]``)."""

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
        return (self._n_categories,)

    def _categories(self, generator, prefix, eps):
        """Category indices of shape ``prefix + batch_shape``:
        ``argmax(logits + Gumbel)`` with the Gumbels ``-log(-log u)`` of
        open-interval uniforms (``jax.random.categorical``'s draw)."""
        u = self._open_uniforms(
            generator, prefix + self.batch_shape + (self._n_categories,),
            eps)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(gumbel + self._logits.detach(), dim=-1)

    def _normalized_logits(self):
        logits = self._logits
        if self._normalize_logits:
            logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        return logits


class Multinomial(_Logits):
    """Multinomial counts over K categories.

    Parity: reference ``multivariate.py:195-336``. ``logits``: ``[..., K]``
    unnormalized log-probabilities; ``n_experiments``: a positive int, a
    0-D integer tensor, or None, in which case the trial count is read from
    ``given`` when scoring and sampling raises (multivariate.py:207-213,
    327-330). ``normalize_logits`` subtracts the logsumexp
    (multivariate.py:324-326); the density adds ``log_combination``
    (multivariate.py:331-333).

    Sampler (the JAX package's split, multivariate.py:321-343): for an int
    ``n <= 64``, the one-hot sum of ``n`` categorical draws a sample (the
    Gumbel argmax of :class:`OnehotCategorical` with uniforms of shape
    ``(n_samples, n) + batch_shape + [K]``; ``eps=`` supplies them);
    otherwise ``K - 1`` conditional binomial splits with
    ``torch.binomial`` (no ``eps=``).
    """

    def __init__(
        self,
        logits,
        n_experiments,
        normalize_logits: bool = True,
        dtype=torch.int32,
        group_ndims: int = 0,
        **kwargs,
    ):
        super().__init__(logits, dtype, group_ndims, **kwargs)
        self._n_experiments = _trial_count(n_experiments, True, self.device)
        self._normalize_logits = normalize_logits

    n_experiments = property(lambda self: self._n_experiments)

    def _sample(self, generator, n_samples, eps):
        if self._n_experiments is None:
            raise ValueError(
                "Cannot sample when `n_experiments` is None (parity with "
                "reference multivariate.py:327-330).")
        n = self._n_experiments
        if isinstance(n, int) and n <= _DIRECT_SAMPLE_MAX_N:
            cats = self._categories(generator, (n_samples, n), eps)
            counts = torch.nn.functional.one_hot(
                cats, self._n_categories).sum(dim=1)
            return counts.to(self.dtype)
        self._no_eps(eps, generator, "torch's binomial sampler")
        shape = (n_samples,) + self.batch_shape
        probs = torch.softmax(self._logits.detach(), dim=-1).expand(
            shape + (self._n_categories,))
        # The probability mass of categories k..K-1, so that each split's
        # success probability p_k / tail_k does not drift.
        tail = torch.flip(torch.cumsum(torch.flip(probs, (-1,)), -1), (-1,))
        remaining = torch.as_tensor(n, dtype=self.param_dtype,
                                    device=self.device).expand(shape)
        counts = []
        for k in range(self._n_categories - 1):
            q = torch.clamp(probs[..., k] / tail[..., k], 0.0, 1.0)
            c = torch.binomial(remaining.contiguous(), q.contiguous(),
                               generator=generator)
            counts.append(c)
            remaining = remaining - c
        counts.append(remaining)
        return torch.stack(counts, dim=-1).to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        logits = self._normalized_logits()
        if self._n_experiments is None:
            n = torch.sum(x, dim=-1)
        else:
            n = torch.as_tensor(self._n_experiments, dtype=self.param_dtype,
                                device=self.device)
        return log_combination(n, x) + torch.sum(x * logits, dim=-1)


class UnnormalizedMultinomial(_Logits):
    """Bag-of-categoricals scoring: the multinomial without its
    coefficient.

    Parity: reference ``multivariate.py:339-449``. Sampling raises
    (multivariate.py:429-433); the density is ``sum(given * logits)``, the
    logits normalized by default.
    """

    def __init__(
        self,
        logits,
        normalize_logits: bool = True,
        dtype=torch.int32,
        group_ndims: int = 0,
        **kwargs,
    ):
        super().__init__(logits, dtype, group_ndims, **kwargs)
        self._normalize_logits = normalize_logits

    def _sample(self, generator, n_samples, eps):
        raise NotImplementedError(
            "UnnormalizedMultinomial distribution does not support sampling "
            "(parity with reference multivariate.py:429-433).")

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        return torch.sum(x * self._normalized_logits(), dim=-1)


BagofCategoricals = UnnormalizedMultinomial


class OnehotCategorical(_Logits):
    """One-hot coded Categorical.

    Parity: reference ``multivariate.py:452-567``. Sampler: a categorical
    draw (``argmax(logits + Gumbel)``, the Gumbels from open-interval
    uniforms of shape ``([n] +) batch_shape + [K]``; ``eps=`` supplies
    them), then one-hot (multivariate.py:522-540); density
    ``sum(given * log_softmax(logits))`` (multivariate.py:542-561).
    """

    def _sample(self, generator, n_samples, eps):
        cats = self._categories(generator, (n_samples,), eps)
        return torch.nn.functional.one_hot(
            cats, self._n_categories).to(self.dtype)

    def _log_prob(self, given):
        x = given.to(self.param_dtype)
        log_p = torch.log_softmax(self._logits, dim=-1)
        return torch.sum(x * log_p, dim=-1)


OnehotDiscrete = OnehotCategorical


class Dirichlet(Distribution):
    """Dirichlet on the (K-1)-simplex.

    Parity: reference ``multivariate.py:570-680``. ``alpha``: ``[..., K]``,
    K >= 2 (multivariate.py:602-623). Density ``-lbeta(alpha) +
    sum((alpha-1)*log(x))`` (multivariate.py:665-677). Sampler: with
    ``is_reparameterized=True`` normalized Gammas from torch's implicitly
    differentiable gamma sampler (the JAX package's construction,
    multivariate.py:511-519), else torch's Dirichlet sampler (the JAX
    package's ``jax.random.dirichlet``); no ``eps=``.
    """

    def __init__(self, alpha, group_ndims: int = 0,
                 is_reparameterized: bool = False,
                 use_path_derivative: bool = False,
                 check_numerics=False, **kwargs):
        device = param_device(alpha)
        dtype = assert_same_float_dtype([(alpha, "alpha")])
        self._alpha = as_param(alpha, dtype, device)
        if self._alpha.ndim < 1:
            raise ValueError(
                "alpha must be at least 1-D (..., n_categories).")
        self._n_categories = self._alpha.shape[-1]
        if self._n_categories < 2:
            raise ValueError(
                "n_categories (last axis of alpha) must be at least 2.")
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

    alpha = property(lambda self: self._alpha)
    n_categories = property(lambda self: self._n_categories)

    def _batch_shape(self):
        return tuple(self._alpha.shape[:-1])

    def _value_shape(self):
        return (self._n_categories,)

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma and Dirichlet samplers")
        shape = (n_samples,) + self.batch_shape + (self._n_categories,)
        if self.is_reparameterized:
            g = torch._standard_gamma(self._alpha.expand(shape),
                                      generator=generator)
            return g / torch.sum(g, dim=-1, keepdim=True)
        return torch._sample_dirichlet(
            self._alpha.detach().expand(shape).contiguous(),
            generator=generator)

    def _log_prob(self, given):
        alpha = self.path_param(self._alpha)
        lbeta = (torch.sum(torch.lgamma(alpha), dim=-1)
                 - torch.lgamma(torch.sum(alpha, dim=-1)))
        log_given = torch.log(given)
        if self._check_numerics:
            log_given = check_numerics(log_given, "log(given)")
            lbeta = check_numerics(lbeta, "lbeta(alpha)")
        return torch.sum((alpha - 1.0) * log_given, dim=-1) - lbeta


class _ConcreteBase(Distribution):
    """The shared constructor and Gumbel draw of :class:`ExpConcrete` and
    :class:`Concrete`: a scalar ``temperature`` and ``logits`` of shape
    ``batch_shape + [K]``."""

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
        if self._logits.ndim < 1:
            raise ValueError(
                "logits must be at least 1-D (..., n_categories).")
        self._n_categories = self._logits.shape[-1]
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
    n_categories = property(lambda self: self._n_categories)

    def _batch_shape(self):
        return tuple(self._logits.shape[:-1])

    def _value_shape(self):
        return (self._n_categories,)

    def _perturbed(self, generator, n_samples, eps):
        """``(logits + Gumbel) / temperature`` with the Gumbels from
        open-interval uniforms of the sample's shape (``eps=`` supplies
        them)."""
        logits, temperature = self._logits, self._temperature
        if not self.is_reparameterized:
            logits, temperature = logits.detach(), temperature.detach()
        shape = (n_samples,) + self.batch_shape + (self._n_categories,)
        u = self._open_uniforms(generator, shape, eps)
        gumbel = -torch.log(-torch.log(u))
        return (logits + gumbel) / temperature

    def _log_temperature(self, temperature):
        log_temperature = torch.log(temperature)
        if self._check_numerics:
            log_temperature = check_numerics(log_temperature,
                                             "log(temperature)")
        return log_temperature

    def _lgamma_n(self):
        return torch.lgamma(torch.tensor(float(self._n_categories),
                                         dtype=self.param_dtype,
                                         device=self.device))


class ExpConcrete(_ConcreteBase):
    """ExpConcrete (Maddison et al. 2017): the Concrete in log-simplex
    coordinates (non-positive values whose logsumexp is 0).

    Parity: reference ``multivariate.py:683-817``. Sampler
    ``log_softmax((logits + Gumbel) / temperature)``
    (multivariate.py:781-795); density, with ``t = logits -
    temperature*y``: ``lgamma(K) + (K-1)*log(temperature) + sum(t) -
    K*logsumexp(t)`` (multivariate.py:797-811). Reparameterized.
    """

    def _sample(self, generator, n_samples, eps):
        return torch.log_softmax(self._perturbed(generator, n_samples, eps),
                                 dim=-1)

    def _log_prob(self, given):
        temperature = self.path_param(self._temperature)
        logits = self.path_param(self._logits)
        n = self._n_categories
        log_temperature = self._log_temperature(temperature)
        t = logits - temperature * given
        return (self._lgamma_n() + (n - 1) * log_temperature
                + torch.sum(t, dim=-1) - n * torch.logsumexp(t, dim=-1))


ExpGumbelSoftmax = ExpConcrete


class Concrete(_ConcreteBase):
    """Concrete / Gumbel-Softmax on the open simplex.

    Parity: reference ``multivariate.py:820-958``. Sampler
    ``softmax((logits + Gumbel) / temperature)`` (multivariate.py:919-934);
    density ``lgamma(K) + (K-1)*log(temperature) + sum(logits -
    (temperature+1)*log(x)) - K*logsumexp(logits - temperature*log(x))``
    (multivariate.py:936-952). Reparameterized.
    """

    def _sample(self, generator, n_samples, eps):
        return torch.softmax(self._perturbed(generator, n_samples, eps),
                             dim=-1)

    def _log_prob(self, given):
        temperature = self.path_param(self._temperature)
        logits = self.path_param(self._logits)
        n = self._n_categories
        log_given = torch.log(given)
        if self._check_numerics:
            log_given = check_numerics(log_given, "log(given)")
        log_temperature = self._log_temperature(temperature)
        t = logits - temperature * log_given
        return (self._lgamma_n() + (n - 1) * log_temperature
                + torch.sum(t - log_given, dim=-1)
                - n * torch.logsumexp(t, dim=-1))


GumbelSoftmax = Concrete


def _log_det_tril(tril):
    """``2 * sum(log(diag(L)))`` over the last two axes."""
    return 2.0 * torch.sum(
        torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)), dim=-1)


class MatrixVariateNormalCholesky(Distribution):
    """Matrix-variate Normal with Cholesky-factored row and column
    covariances.

    Parity: reference ``multivariate.py:961-1160``. ``mean``: ``[..., n,
    m]``; ``u_tril``: ``[..., n, n]`` (the row covariance's factor);
    ``v_tril``: ``[..., m, m]`` (the column covariance's). Sampler ``mean +
    Lu @ eps @ Lv^T`` with ``eps`` standard normals of the sample's shape
    (multivariate.py:1099-1122; ``eps=`` supplies them); density by two
    batched triangular solves (multivariate.py:1124-1157).
    Reparameterized.
    """

    def __init__(
        self,
        mean,
        u_tril,
        v_tril,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        use_path_derivative: bool = False,
        check_numerics: bool = False,
        **kwargs,
    ):
        dtype = assert_same_float_dtype(
            [(mean, "mean"), (u_tril, "u_tril"), (v_tril, "v_tril")])
        device = param_device(mean, u_tril, v_tril)
        self._mean = as_param(mean, dtype, device)
        self._u_tril = as_param(u_tril, dtype, device)
        self._v_tril = as_param(v_tril, dtype, device)
        if self._mean.ndim < 2:
            raise ValueError("mean must be at least 2-D ([..., n, m]).")
        n, m = self._mean.shape[-2:]
        if tuple(self._u_tril.shape[-2:]) != (n, n):
            raise ValueError(
                "u_tril trailing dims must be [n, n] matching mean rows "
                "({} vs. {}).".format(tuple(self._u_tril.shape),
                                      tuple(self._mean.shape)))
        if tuple(self._v_tril.shape[-2:]) != (m, m):
            raise ValueError(
                "v_tril trailing dims must be [m, m] matching mean cols "
                "({} vs. {}).".format(tuple(self._v_tril.shape),
                                      tuple(self._mean.shape)))
        self._n_row, self._n_col = n, m
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

    mean = property(lambda self: self._mean)
    u_tril = property(lambda self: self._u_tril)
    v_tril = property(lambda self: self._v_tril)

    def _batch_shape(self):
        return broadcast_shapes(self._mean.shape[:-2],
                                self._u_tril.shape[:-2],
                                self._v_tril.shape[:-2])

    def _value_shape(self):
        return (self._n_row, self._n_col)

    def _sample(self, generator, n_samples, eps):
        mean, u_tril, v_tril = self._mean, self._u_tril, self._v_tril
        if not self.is_reparameterized:
            mean, u_tril, v_tril = (mean.detach(), u_tril.detach(),
                                    v_tril.detach())
        shape = (n_samples,) + self.batch_shape + (self._n_row, self._n_col)
        eps = self._normals(generator, shape, eps)
        return mean + u_tril @ eps @ torch.transpose(v_tril, -1, -2)

    def _log_prob(self, given):
        mean = self.path_param(self._mean)
        u_tril = self.path_param(self._u_tril)
        v_tril = self.path_param(self._v_tril)
        n, m = self._n_row, self._n_col
        log_det_u = _log_det_tril(u_tril)
        log_det_v = _log_det_tril(v_tril)
        if self._check_numerics:
            log_det_u = check_numerics(log_det_u, "log_det(u_tril)")
            log_det_v = check_numerics(log_det_v, "log_det(v_tril)")
        y = given - mean
        target_shape = broadcast_shapes(y.shape, self.batch_shape + (n, m))
        y = y.expand(target_shape)
        u_b = u_tril.expand(target_shape[:-2] + (n, n))
        v_b = v_tril.expand(target_shape[:-2] + (m, m))
        # z = Lu^{-1} (X - M) Lv^{-T}; its Frobenius norm is the
        # Mahalanobis term.
        z = torch.linalg.solve_triangular(u_b, y, upper=False)
        z = torch.transpose(torch.linalg.solve_triangular(
            v_b, torch.transpose(z, -1, -2), upper=False), -1, -2)
        maha = torch.sum(z ** 2, dim=(-1, -2))
        return (-0.5 * (n * m * _LOG_2PI + maha)
                - 0.5 * (m * log_det_u + n * log_det_v))


class MultivariateStudentTCholesky(Distribution):
    """Multivariate Student's t with ``df``, location ``loc`` and the
    Cholesky factor ``scale_tril`` of its scale matrix (the JAX package's,
    beyond the reference)::

        pdf(x) = G((v+d)/2) / [G(v/2) (v pi)^{d/2} |L|]
                 * (1 + maha(x)/v)^{-(v+d)/2}

    Sampler ``loc + (L z) * sqrt(v / g)`` with ``z`` standard normal and
    ``g ~ chi2(v)`` (twice a Gamma(v/2) from torch's sampler; no
    ``eps=``): reparameterized in ``loc`` and ``scale_tril``, ``df``
    detached in the draw (its density gradient stays exact).

    :param df: degrees of freedom ``v > 0``, broadcastable over the batch
        shape.
    :param loc: ``[..., d]`` location.
    :param scale_tril: ``[..., d, d]`` lower-triangular scale factor.
    """

    def __init__(
        self,
        df,
        loc,
        scale_tril,
        group_ndims: int = 0,
        is_reparameterized: bool = True,
        use_path_derivative: bool = False,
        check_numerics: bool = False,
        **kwargs,
    ):
        dtype = assert_same_float_dtype(
            [(df, "df"), (loc, "loc"), (scale_tril, "scale_tril")])
        device = param_device(df, loc, scale_tril)
        self._df = as_param(df, dtype, device)
        self._loc = as_param(loc, dtype, device)
        self._scale_tril = as_param(scale_tril, dtype, device)
        if self._loc.ndim < 1:
            raise ValueError("loc must be at least 1-D ([..., d]).")
        if self._scale_tril.ndim < 2:
            raise ValueError(
                "scale_tril must be at least 2-D ([..., d, d]).")
        d = self._loc.shape[-1]
        if tuple(self._scale_tril.shape[-2:]) != (d, d):
            raise ValueError(
                "scale_tril trailing dims must be [d, d] with d matching "
                "loc ({} vs. {}).".format(tuple(self._scale_tril.shape),
                                          tuple(self._loc.shape)))
        self._n_dim = d
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

    df = property(lambda self: self._df)
    loc = property(lambda self: self._loc)
    scale_tril = property(lambda self: self._scale_tril)

    def _batch_shape(self):
        return broadcast_shapes(self._df.shape, self._loc.shape[:-1],
                                self._scale_tril.shape[:-2])

    def _value_shape(self):
        return (self._n_dim,)

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma sampler")
        loc, scale_tril = self._loc, self._scale_tril
        if not self.is_reparameterized:
            loc, scale_tril = loc.detach(), scale_tril.detach()
        df = self._df.detach()
        shape = (n_samples,) + self.batch_shape + (self._n_dim,)
        z = torch.randn(shape, generator=generator, dtype=self.dtype,
                        device=self.device)
        gauss = torch.matmul(scale_tril, z[..., None]).squeeze(-1)
        half_df = (0.5 * df).expand(shape[:-1])
        g = 2.0 * torch._standard_gamma(half_df, generator=generator)
        return loc + gauss * torch.sqrt(df / g)[..., None]

    def _log_prob(self, given):
        df = self.path_param(self._df)
        loc = self.path_param(self._loc)
        scale_tril = self.path_param(self._scale_tril)
        d = self._n_dim
        log_diag = torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1))
        log_diag = check_numerics(log_diag, "log(diag(scale_tril))",
                                  self._check_numerics)
        half_log_det = torch.sum(log_diag, dim=-1)
        y = given - loc
        target_shape = broadcast_shapes(y.shape, self.batch_shape + (d,))
        y = y.expand(target_shape)
        z = torch.linalg.solve_triangular(
            scale_tril.expand(target_shape[:-1] + (d, d)), y[..., None],
            upper=False)
        maha = torch.sum(z.squeeze(-1) ** 2, dim=-1)
        return (torch.lgamma(0.5 * (df + d)) - torch.lgamma(0.5 * df)
                - 0.5 * d * torch.log(df * np.pi) - half_log_det
                - 0.5 * (df + d) * torch.log1p(maha / df))
