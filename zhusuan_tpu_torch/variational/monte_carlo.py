"""Importance-weighted (multi-sample Monte Carlo) objective.

Port of ``zhusuan_tpu/variational/monte_carlo.py`` (parity: reference
``zhusuan/variational/monte_carlo.py``): ``ImportanceWeightedObjective``
(:24-227) with ``sgvb`` (IWAE, :143-164), ``dreg`` (Tucker et al. 2019,
beyond the reference) and ``vimco`` (:166-227), and the factories
``importance_weighted_objective`` / ``iw_objective`` (:230-268).
``stop_gradient`` is ``detach``; VIMCO's leave-one-out control variate is a
K x K ``torch.where`` on the identity, as in the JAX package.
"""

from __future__ import annotations

import warnings

import torch

from zhusuan_tpu_torch.utils import log_mean_exp
from zhusuan_tpu_torch.variational.base import VariationalObjective

__all__ = [
    "ImportanceWeightedObjective",
    "importance_weighted_objective",
    "iw_objective",
]


class ImportanceWeightedObjective(VariationalObjective):
    """The multi-sample importance-weighted lower bound (Burda 2015); also
    the self-normalized IS estimate of the marginal log-likelihood used by
    :func:`zhusuan_tpu_torch.evaluation.is_loglikelihood`.

    :param axis: the sample axis (required: the objective is multi-sample).
    """

    def __init__(self, meta_bn, observed, latent=None, axis=None,
                 variational=None):
        if axis is None:
            raise ValueError(
                "ImportanceWeightedObjective is a multi-sample objective; "
                "the `axis` argument must be specified.")
        self._axis = axis
        super().__init__(meta_bn, observed, latent=latent,
                         variational=variational)

    def _log_w(self):
        return self._log_joint_term() + self._entropy_term()

    def _objective(self):
        """``log_mean_exp(log_joint + entropy, axis)`` (reference
        monte_carlo.py:137-141)."""
        return log_mean_exp(self._log_w(), axis=self._axis)

    def sgvb(self):
        """IWAE estimator: reparameterized gradient of the IW bound
        (reference monte_carlo.py:143-164)."""
        return -self.tensor

    def dreg(self):
        """Doubly-reparameterized gradient estimator (DReG; Tucker, Lawson,
        Gu & Maddison, ICLR 2019), as in the JAX package: the variational
        path gradient re-weighted by the squared self-normalized weights
        ``w~_i^2``, and a second model pass at the detached samples that
        restores the IWAE ``w~_i`` weighting for the model parameters.
        With K = 1 it is the "sticking the landing" estimator.

        Requires every variational node to be reparameterized and built
        with ``use_path_derivative=True`` (checked when the objective was
        built with ``variational=``; with raw ``latent=`` pairs the caller
        must have detached the parameters inside ``log_probs``, which
        cannot be checked, so a warning is emitted).

        :return: a cost whose value is ``-bound`` (as :meth:`sgvb`) and
            whose gradient is the DReG estimator.
        """
        if self._v_nodes is None:
            warnings.warn(
                "dreg() was built from raw latent=(samples, log_probs) "
                "pairs: it cannot verify that the score term of log q is "
                "stopped (use_path_derivative). If the parameter gradient "
                "was not stopped inside log_probs, the returned gradient "
                "is silently wrong — prefer constructing the objective "
                "with variational=.",
                stacklevel=2)
        else:
            for name, node in self._v_nodes.items():
                if not node.dist.is_reparameterized:
                    raise ValueError(
                        "dreg() requires reparameterized variational nodes; "
                        "node {!r} is not.".format(name))
                if not node.dist.use_path_derivative:
                    raise ValueError(
                        "dreg() requires every variational node to be built "
                        "with use_path_derivative=True (the score term of "
                        "log q must be stopped); node {!r} was not.".format(
                            name))
        log_w = self._log_w()
        axis = self._axis
        w = torch.softmax(log_w, dim=axis).detach()
        # Path term: the squared-weight surrogate (log q's direct
        # dependence on its parameters is detached by use_path_derivative).
        surrogate = torch.sum(w * w * log_w, dim=axis)
        # Model-parameter correction: (w - w^2)-weighted log p at the
        # detached samples restores the IWAE weighting for the model.
        sg_obs = {k: v.detach() for k, v in self._v_inputs.items()}
        sg_obs.update(self._observed)
        log_p_sg = self._log_joint_at(sg_obs)
        surrogate = surrogate + torch.sum((w - w * w) * log_p_sg, dim=axis)
        bound = log_mean_exp(log_w, axis=axis)
        return -(surrogate - surrogate.detach() + bound.detach())

    def vimco(self):
        """VIMCO multi-sample score-function estimator (Mnih & Rezende 2016;
        reference ``monte_carlo.py:166-227``); the size along ``axis`` must
        be at least 2."""
        log_w = self._log_w()
        axis = self._axis
        k = log_w.shape[axis]
        if k < 2:
            raise ValueError(
                "VIMCO is a multi-sample gradient estimator, size along "
                "`axis` in the objective should be larger than 1.")
        # Leave-one-out geometric-mean control variate: for each sample j,
        # log_w_j replaced by the mean of the others, then log-mean-exp.
        l_signal = torch.movedim(log_w, axis, -1)  # [..., K]
        sub = (torch.sum(l_signal, dim=-1, keepdim=True) - l_signal) / (k - 1)
        eye = torch.eye(k, dtype=torch.bool, device=log_w.device)
        # x_ex[..., j, i] = l_i for i != j, sub_j for i == j.
        x_ex = torch.where(eye, sub[..., :, None], l_signal[..., None, :])
        control_variate = torch.movedim(log_mean_exp(x_ex, axis=-1), -1,
                                        axis)
        # The variance-reduced learning signal, then the surrogate cost
        # (reference monte_carlo.py:220-227).
        bound = log_mean_exp(log_w, axis=axis, keepdims=True)
        l_sig = bound - control_variate
        fake_term = torch.sum(-self._entropy_term() * l_sig.detach(),
                              dim=axis)
        return -fake_term - log_mean_exp(log_w, axis=axis)


def importance_weighted_objective(meta_bn, observed, latent=None, axis=None,
                                  variational=None):
    """Factory for :class:`ImportanceWeightedObjective` (reference
    monte_carlo.py:230-264).

    :param meta_bn: MetaBayesianNet or log-joint callable.
    :param observed: dict of observations.
    :param latent: ``{name: (samples, log_probs)}`` (exclusive with
        ``variational``).
    :param axis: the sample axis (required).
    :param variational: a BayesianNet variational family.
    """
    return ImportanceWeightedObjective(meta_bn, observed, latent=latent,
                                       axis=axis, variational=variational)


iw_objective = importance_weighted_objective
