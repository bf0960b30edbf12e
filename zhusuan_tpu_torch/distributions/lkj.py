"""LKJ correlation-Cholesky prior (Lewandowski, Kurowicka & Joe 2009).

Port of ``zhusuan_tpu/distributions/lkj.py``: ``LKJCholesky(d, eta)`` is a
distribution over LOWER Cholesky factors ``L`` of correlation matrices
(``C = L L^T``, unit diagonal), with density ``p(C) ∝ det(C)^(eta-1)``.

Construction (the C-vine / canonical-partial-correlation form): the free
coordinates are CPCs ``z_ij`` (one per strictly-lower entry), independently
``2 Beta(a_j, a_j) - 1`` with column-wise ``a_j = eta + (d - 2 - j)/2``
(0-indexed column ``j``); rows of ``L`` fill as ``L_ij = z_ij w_ij`` with
the remaining-norm recursion ``w_i0 = 1``, ``w_{i,j+1}^2 = w_ij^2 -
L_ij^2``, and ``L_ii = w_ii``. ``log_prob`` inverts that map column by
column and sums the scaled-Beta log-densities and the log-Jacobian ``-sum
log w_ij`` (``lkj.py:137-175``), with its ``tiny`` and ``1e-12`` guards and
the support mask's float32-sized tolerances (``lkj.py:120-135``).

The sampler draws batched Betas from torch's Dirichlet sampler (the JAX
package's ``jax.random.beta``): it takes no ``eps=``, and is held to the
JAX package by its moments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.utils import (
    as_param,
    assert_same_float_dtype,
    param_device,
)

__all__ = ["LKJCholesky"]

_LOG2 = math.log(2.0)


def _scaled_beta_logpdf(z, a):
    """log pdf of ``z = 2 Beta(a, a) - 1`` on (-1, 1)."""
    log_beta_fn = torch.lgamma(a) + torch.lgamma(a) - torch.lgamma(2.0 * a)
    return ((a - 1.0) * torch.log1p(-z * z) - (2.0 * a - 1.0) * _LOG2
            - log_beta_fn)


class LKJCholesky(Distribution):
    """LKJ prior over lower-Cholesky factors of correlation matrices.

    :param d: matrix dimension (Python int >= 2).
    :param eta: concentration (> 0): ``eta = 1`` is uniform over
        correlation matrices; ``eta > 1`` concentrates near the identity;
        ``eta < 1`` favours strong correlations. Scalar.
    :param group_ndims: trailing batch axes to sum in ``log_prob``.
    """

    def __init__(self, d: int, eta, group_ndims: int = 0, **kwargs):
        if isinstance(d, bool) or not isinstance(d, (int, np.integer)) \
                or d < 2:
            raise ValueError(
                "d must be a Python int >= 2, got {!r}.".format(d))
        dtype = assert_same_float_dtype([(eta, "eta")])
        device = param_device(eta)
        self._d = int(d)
        self._eta = as_param(eta, dtype, device)
        if self._eta.ndim != 0:
            raise ValueError("eta must be a scalar.")
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=True,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    d = property(lambda self: self._d)
    eta = property(lambda self: self._eta)

    def _batch_shape(self):
        return ()

    def _value_shape(self):
        return (self._d, self._d)

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's Dirichlet sampler")
        d = self._d
        eta = self._eta.detach()
        w = torch.ones((n_samples, d), dtype=self.dtype, device=self.device)
        L = torch.zeros((n_samples, d, d), dtype=self.dtype,
                        device=self.device)
        row_idx = torch.arange(d, device=self.device)
        # Columns 0 .. d-2 carry CPC draws; the diagonal closes each row.
        for j in range(d - 1):
            a = (eta + 0.5 * (d - 2 - j)).expand((n_samples, d, 2))
            z = 2.0 * torch._sample_dirichlet(
                a.contiguous(), generator=generator)[..., 0] - 1.0
            is_diag = row_idx == j
            is_below = row_idx > j
            col = torch.where(is_diag, w,
                              torch.where(is_below, z * w,
                                          torch.zeros_like(w)))
            L[:, :, j] = col
            # The remaining norm changes only for the rows below j.
            w = torch.where(
                is_below, torch.sqrt(torch.clamp(w * w - col * col, min=0.0)),
                w)
        L[:, d - 1, d - 1] = w[:, d - 1]
        return L

    def _support_mask(self, L):
        """True where ``L`` is a valid correlation Cholesky factor:
        lower-triangular, positive diagonal, unit row norms, within
        tolerances sized for float32 round trips."""
        upper_zero = torch.all(
            (torch.abs(torch.triu(L, diagonal=1)) < 1e-5).flatten(-2), -1)
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        diag_pos = torch.all(diag > 0, dim=-1)
        row_norms = torch.sum(L * L, dim=-1)
        unit_rows = torch.all(torch.abs(row_norms - 1.0) < 1e-4, dim=-1)
        return upper_zero & diag_pos & unit_rows

    def _log_prob(self, given):
        d = self._d
        L = given.to(self.param_dtype)
        eta = self._eta
        lp = torch.zeros(L.shape[:-2], dtype=self.param_dtype,
                         device=L.device)
        w = torch.ones(L.shape[:-1], dtype=self.param_dtype, device=L.device)
        row_idx = torch.arange(d, device=L.device)
        tiny = torch.finfo(self.param_dtype).tiny
        zero = torch.zeros((), dtype=self.param_dtype, device=L.device)
        for j in range(d - 1):
            a = eta + 0.5 * (d - 2 - j)
            below = row_idx > j
            w_safe = torch.clamp(w, min=tiny)
            z = torch.where(below, L[..., :, j] / w_safe, zero)
            # The scaled-Beta density of each CPC minus the log-Jacobian
            # (dL_ij / dz_ij = w_ij), summed over the rows below the
            # diagonal.
            term = torch.where(
                below,
                _scaled_beta_logpdf(
                    torch.clamp(z, -1.0 + 1e-12, 1.0 - 1e-12), a)
                - torch.log(w_safe),
                zero)
            lp = lp + torch.sum(term, dim=-1)
            w = torch.where(
                below,
                torch.sqrt(torch.clamp(w * w - L[..., :, j] ** 2, min=0.0)),
                w)
        # Out-of-support inputs (where the guards above would give a
        # plausible finite value) score -inf.
        return torch.where(self._support_mask(L), lp,
                           torch.full_like(lp, -math.inf))
