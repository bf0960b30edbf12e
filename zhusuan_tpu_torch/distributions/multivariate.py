"""Multivariate distributions.

Port of ``zhusuan_tpu/distributions/multivariate.py``; so far only
:class:`MultivariateNormalCholesky` (parity: reference
``multivariate.py:41-192``). The other eleven classes come with later
slices of the port.
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

__all__ = ["MultivariateNormalCholesky"]

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
