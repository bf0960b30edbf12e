"""Wishart distribution over positive-definite matrices.

Port of ``zhusuan_tpu/distributions/wishart.py``. Sampler: the Bartlett
decomposition, ``W = L A A^T L^T`` with ``L`` the scale's Cholesky factor
and ``A`` lower-triangular with ``A_ii = sqrt(chi2(df - i))`` and ``A_ij ~
N(0, 1)`` below the diagonal, all batched. The chi-square draws come from
torch's gamma sampler, so the class takes no ``eps=`` and is held to the
JAX package by its moments.

Density (for PD ``X``, ``df >= d``):
``log p(X) = ((df - d - 1)/2) logdet X - tr(S^{-1} X)/2 - (df d/2) log 2
- (df/2) logdet S - log Gamma_d(df/2)``.

The JAX package's ``jnp.linalg.cholesky`` symmetrizes its input and returns
NaN outside the PD cone, which ``log_prob`` turns into ``-inf``
(``wishart.py:128-135``). ``torch.linalg.cholesky`` raises there, so this
port factors ``(X + X^T) / 2`` with ``torch.linalg.cholesky_ex`` and masks
on its ``info``: a non-PD ``given`` scores ``-inf`` and nothing raises. A
non-PD ``scale`` gives a NaN factor, as in JAX.
"""

from __future__ import annotations

import math

import torch

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.utils import (
    as_param,
    assert_same_float_dtype,
    param_device,
)

__all__ = ["Wishart"]

_LOG2 = math.log(2.0)


def _cholesky(x):
    """The lower Cholesky factor of ``(x + x^T) / 2`` and whether each
    matrix is positive definite (its factor finite)."""
    sym = 0.5 * (x + x.transpose(-1, -2))
    chol, info = torch.linalg.cholesky_ex(sym)
    ok = (info == 0) & torch.all(
        torch.isfinite(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return chol, ok


class Wishart(Distribution):
    """Wishart ``W(df, scale)`` over ``[d, d]`` positive-definite matrices.

    :param df: degrees of freedom (a Python number or 0-d array, ``df >=
        d``; it sets the chi-square shapes).
    :param scale: ``[d, d]`` positive-definite scale matrix ``S`` (``E[W] =
        df S``).
    :param group_ndims: trailing batch axes to sum in ``log_prob``.
    """

    def __init__(self, df, scale, group_ndims: int = 0, **kwargs):
        dtype = assert_same_float_dtype([(scale, "scale")])
        device = param_device(scale)
        self._scale = as_param(scale, dtype, device)
        if self._scale.ndim != 2 or (
                self._scale.shape[0] != self._scale.shape[1]):
            raise ValueError(
                "scale must be a square [d, d] matrix; got shape {}."
                .format(tuple(self._scale.shape)))
        d = int(self._scale.shape[0])
        df_f = float(df)
        if df_f < d:
            raise ValueError(
                "df ({}) must be >= the matrix dimension ({}).".format(
                    df_f, d))
        self._df = df_f
        self._d = d
        chol, ok = _cholesky(self._scale)
        self._chol = torch.where(ok, chol, torch.full_like(chol, math.nan))
        super().__init__(
            dtype=dtype,
            param_dtype=dtype,
            is_continuous=True,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=device,
            **kwargs,
        )

    df = property(lambda self: self._df)
    scale = property(lambda self: self._scale)

    def _batch_shape(self):
        return ()

    def _value_shape(self):
        return (self._d, self._d)

    def _sample(self, generator, n_samples, eps):
        self._no_eps(eps, generator, "torch's gamma sampler")
        d, df = self._d, self._df
        # Bartlett: A_ii^2 ~ chi2(df - i) = Gamma((df - i)/2, scale 2).
        shapes = torch.tensor([(df - i) / 2.0 for i in range(d)],
                              dtype=self.dtype, device=self.device)
        g = torch._standard_gamma(shapes.expand((n_samples, d)).contiguous(),
                                  generator=generator)
        diag = torch.sqrt(2.0 * g)
        off = torch.randn((n_samples, d, d), generator=generator,
                          dtype=self.dtype, device=self.device)
        a = torch.tril(off, diagonal=-1) + torch.diag_embed(diag)
        chol = self._chol.detach()
        la = torch.einsum("ij,njk->nik", chol, a)
        return torch.einsum("nik,njk->nij", la, la)

    def _log_prob(self, given):
        d = self._d
        df = self._df
        x = given.to(self.param_dtype)
        chol_x, ok = _cholesky(x)
        logdet_x = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol_x, dim1=-2, dim2=-1)), dim=-1)
        # tr(S^{-1} X) = ||L^{-1} C||_F^2 with X = C C^T.
        chol_s = self._chol.to(x.device)
        solved = torch.linalg.solve_triangular(
            chol_s.expand(chol_x.shape), chol_x, upper=False)
        trace = torch.sum(solved * solved, dim=(-2, -1))
        logdet_s = 2.0 * torch.sum(torch.log(torch.diagonal(chol_s)))
        mvlgamma = torch.special.multigammaln(
            torch.tensor(0.5 * df, dtype=self.param_dtype), d)
        lp = (0.5 * (df - d - 1.0) * logdet_x
              - 0.5 * trace
              - 0.5 * df * d * _LOG2
              - 0.5 * df * logdet_s
              - mvlgamma.to(x.device))
        # Outside the PD cone: -inf, as the JAX package's NaN factor gives.
        return torch.where(ok, lp, torch.full_like(lp, -math.inf))
