"""GP utilities: RBF kernel and sparse GP conditional.

Port of ``examples/gaussian_process/utils.py`` (parity: reference
``examples/gaussian_process/utils.py:10-91``): ``RBFKernel`` with
per-dimension softplus length-scales, and ``gp_conditional`` computing
f(x) | f(z), both the ``full_cov`` branch and the diagonal branch that ELBO
training uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zhusuan_tpu_torch import distributions

__all__ = ["RBFKernel", "gp_conditional"]


class RBFKernel:
    """RBF kernel with per-covariate length-scales
    ``K(x, y) = exp(-0.5 * sum((x - y)^2 / scale))``.

    :param k_raw_scale: raw (pre-softplus) scale parameters
        ``[n_covariates]``.
    """

    def __init__(self, k_raw_scale):
        self.k_scale = F.softplus(k_raw_scale)

    @staticmethod
    def init_params(n_covariates, dtype=torch.float32, device=None):
        return torch.zeros((n_covariates,), dtype=dtype, device=device)

    def __call__(self, x, y):
        """K(x, y): ``[..., n_x, d] x [..., n_y, d] -> [..., n_x, n_y]``."""
        x = x.unsqueeze(-2)  # [..., n_x, 1, d]
        y = y.unsqueeze(-3)  # [..., 1, n_y, d]
        return torch.exp(
            -0.5 * torch.sum(torch.square(x - y) / self.k_scale, dim=-1))

    def Kdiag(self, x):
        """diag(K(x, x)) without forming the Gram matrix."""
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def gp_conditional(z, fz, x, full_cov, kernel, Kzz_chol=None,
                   Kzz_chol_inv=None):
    """The GP conditional distribution f(x) | f(z) = fz (reference
    ``utils.py:52-91``).

    :param z: inducing inputs ``[n_z, d]``.
    :param fz: inducing function values ``[n_particles, n_z]``.
    :param x: query inputs ``[n_x, d]``.
    :param Kzz_chol, Kzz_chol_inv: optional precomputed Cholesky factor of
        the inducing Gram matrix (and its inverse); pass both from
        :func:`zhusuan_tpu_torch.ops.cholesky_inverse` to skip every
        factorization and solve here.
    :return: a distribution over ``[n_particles, n_x]``.
    """
    n_z = z.shape[0]
    if Kzz_chol is None:
        Kzz_chol = torch.linalg.cholesky(kernel(z, z))
    if Kzz_chol_inv is None:
        Kzz_chol_inv = torch.linalg.solve_triangular(
            Kzz_chol, torch.eye(n_z, dtype=z.dtype, device=z.device),
            upper=False)
    Kzz_inv = Kzz_chol_inv.T @ Kzz_chol_inv
    Kxz = kernel(x, z)  # [n_x, n_z]
    Kxziz = Kxz @ Kzz_inv
    mean_fx_given_fz = fz @ Kxziz.T  # [n_particles, n_x]

    if full_cov:
        cov = kernel(x, x) - Kxziz @ Kxz.T
        cov_chol = torch.linalg.cholesky(
            cov + 1e-6 * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                   device=cov.device))
        cov_chol = cov_chol[None].expand((fz.shape[0],) + cov_chol.shape)
        return distributions.MultivariateNormalCholesky(mean_fx_given_fz,
                                                        cov_chol)
    var = kernel.Kdiag(x) - torch.sum((Kxz @ Kzz_chol_inv.T) ** 2, dim=-1)
    std = torch.sqrt(torch.clamp(var, min=1e-8))
    return distributions.Normal(mean_fx_given_fz, std=std, group_ndims=1)
