"""Renyi-divergence (VR) and chi-square (CUBO) variational objectives.

Port of ``zhusuan_tpu/variational/renyi.py`` (beyond the reference, which
stops at ELBO / IWAE / inclusive KL): the two ends of an evidence
sandwich.

* :class:`RenyiDivergenceObjective`, the K-sample variational Renyi bound
  (Li & Turner, NeurIPS 2016),
  ``L_alpha = log mean_i w_i^(1-alpha) / (1 - alpha)``: non-increasing in
  alpha, the multi-sample ELBO at alpha = 1, the IWAE bound at alpha = 0.
* :class:`ChiSquareObjective`, the chi upper bound
  ``CUBO_n = log E_q[w^n] / n`` for ``n >= 1`` (Dieng et al., NeurIPS
  2017); the Monte Carlo log of a mean is biased down, so a finite-K
  estimate can dip below log Z.

``axis`` indexes the K-sample axis of ``log w = log p(x, z) + entropy``;
``stop_gradient`` is ``detach``.
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.utils import log_mean_exp
from zhusuan_tpu_torch.variational.base import VariationalObjective

__all__ = [
    "RenyiDivergenceObjective",
    "ChiSquareObjective",
    "vr_objective",
    "cubo_objective",
]


class RenyiDivergenceObjective(VariationalObjective):
    """K-sample variational Renyi (VR) bound ``L_alpha`` (Li & Turner
    2016). ``alpha`` is a Python float; ``alpha == 1`` is the ELBO limit.
    For ``alpha >= 0`` a lower bound on ``log Z``; :meth:`sgvb` returns
    ``-bound`` as the cost to minimize.

    :param axis: the sample axis (required).
    :param alpha: the Renyi order.
    """

    def __init__(self, meta_bn, observed, latent=None, axis=None,
                 variational=None, alpha=0.5):
        if axis is None:
            raise ValueError(
                "RenyiDivergenceObjective is a multi-sample objective; "
                "the `axis` argument must be specified.")
        self._axis = axis
        self._alpha = float(alpha)
        super().__init__(meta_bn, observed, latent=latent,
                         variational=variational)

    @property
    def alpha(self) -> float:
        return self._alpha

    def _objective(self):
        log_w = self._log_joint_term() + self._entropy_term()
        if self._alpha == 1.0:
            # lim_{alpha -> 1} L_alpha = E_q[log w], the ELBO.
            return torch.mean(log_w, dim=self._axis)
        one_m_alpha = 1.0 - self._alpha
        return log_mean_exp(one_m_alpha * log_w,
                            axis=self._axis) / one_m_alpha

    def sgvb(self):
        """Reparameterized gradient of the VR bound (Li & Turner 2016 eq.
        (7): the importance weights are implicit in the log-mean-exp's
        gradient); cost ``-bound``."""
        return -self.tensor


class ChiSquareObjective(VariationalObjective):
    """The chi upper bound ``CUBO_n`` on ``log Z`` (Dieng et al. 2017);
    minimizing it minimizes the chi^n divergence from q to the posterior.

    :param axis: the sample axis (required).
    :param n: the order, a float >= 1 (default 2: chi-square).
    """

    def __init__(self, meta_bn, observed, latent=None, axis=None,
                 variational=None, n=2.0):
        if axis is None:
            raise ValueError(
                "ChiSquareObjective is a multi-sample objective; the `axis` "
                "argument must be specified.")
        n = float(n)
        if n < 1.0:
            raise ValueError(
                "CUBO_n requires n >= 1 for an upper bound; got n="
                + repr(n))
        self._axis = axis
        self._n = n
        super().__init__(meta_bn, observed, latent=latent,
                         variational=variational)

    @property
    def n(self) -> float:
        return self._n

    def _objective(self):
        log_w = self._log_joint_term() + self._entropy_term()
        return log_mean_exp(self._n * log_w, axis=self._axis) / self._n

    def sgvb(self):
        """Reparameterized gradient of CUBO_n itself; the cost IS the
        bound. High-variance when q is far from the posterior: prefer
        :meth:`exp_sgvb` to optimize."""
        return self.tensor

    def exp_sgvb(self):
        """The exponentiated surrogate ``E_q[w^n] = exp(n CUBO)`` (Dieng et
        al. 2017 sec. 2.3): the same minimizer and an unbiased
        reparameterized gradient. Stabilized by ONE global detached
        log-shift, applied in two stages (each element's own max inside
        the mean, the global correction outside), so the batch's gradient
        stays proportional to the surrogate's (JAX ``renyi.py:139-164``).
        """
        log_w = self._log_joint_term() + self._entropy_term()
        n_log_w = self._n * log_w
        shift = torch.amax(n_log_w, dim=self._axis, keepdim=True).detach()
        global_shift = torch.amax(shift).detach()
        scale = torch.exp(torch.squeeze(shift, self._axis) - global_shift)
        return torch.mean(torch.exp(n_log_w - shift), dim=self._axis) * scale


def vr_objective(meta_bn, observed, latent=None, axis=None, variational=None,
                 alpha=0.5):
    """Factory for :class:`RenyiDivergenceObjective`."""
    return RenyiDivergenceObjective(meta_bn, observed, latent=latent,
                                    axis=axis, variational=variational,
                                    alpha=alpha)


def cubo_objective(meta_bn, observed, latent=None, axis=None,
                   variational=None, n=2.0):
    """Factory for :class:`ChiSquareObjective`."""
    return ChiSquareObjective(meta_bn, observed, latent=latent, axis=axis,
                              variational=variational, n=n)
