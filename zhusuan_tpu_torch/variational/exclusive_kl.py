"""ELBO (exclusive KL divergence) objective and its gradient estimators.

Port of ``zhusuan_tpu/variational/exclusive_kl.py`` (parity: reference
``zhusuan/variational/exclusive_kl.py``): ``EvidenceLowerBoundObjective``
(exclusive_kl.py:24-231) with ``sgvb`` (:139-159) and ``reinforce``
(:161-231), and the ``elbo`` factory (:234-267). The REINFORCE
moving-average baseline is explicit state threaded by the caller
(``moving_mean``), as in the JAX package; ``stop_gradient`` is ``detach``.
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.variational.base import VariationalObjective

__all__ = ["EvidenceLowerBoundObjective", "elbo"]


class EvidenceLowerBoundObjective(VariationalObjective):
    """The evidence lower bound (ELBO): the negative exclusive KL divergence
    up to a constant.

    :param axis: the sample axis (or axes) to average over in the outer
        expectation; None keeps per-sample values.
    """

    def __init__(self, meta_bn, observed, latent=None, axis=None,
                 variational=None):
        self._axis = axis
        super().__init__(meta_bn, observed, latent=latent,
                         variational=variational)

    def _objective(self):
        """log_joint + entropy, averaged over ``axis`` (reference
        exclusive_kl.py:131-137)."""
        lower_bound = self._log_joint_term()
        if self._entropy_term() is not None:
            lower_bound = lower_bound + self._entropy_term()
        if self._axis is not None:
            lower_bound = torch.mean(lower_bound, dim=self._axis)
        return lower_bound

    def sgvb(self):
        """SGVB / reparameterization-trick estimator (Kingma 2013): the
        surrogate cost to minimize (reference exclusive_kl.py:139-159).
        Needs reparameterized latent nodes."""
        return -self.tensor

    def reinforce(self, variance_reduction: bool = True, baseline=None,
                  decay: float = 0.8, moving_mean=None):
        """Score-function (REINFORCE / NVIL) estimator (reference
        ``exclusive_kl.py:161-231``); the centering moving average is
        explicit state.

        :param variance_reduction: center the learning signal.
        :param baseline: optional input-dependent baseline broadcastable to
            the learning signal; when given, an auxiliary ``baseline_cost``
            for training it is also returned.
        :param decay: moving-average decay for the center.
        :param moving_mean: optional scalar tensor carrying the
            moving-average center across steps; when given, its update is
            returned last; when None, the (detached) batch mean centers.
        :return: ``cost``, or ``(cost[, baseline_cost][, new_moving_mean])``.
        """
        l_signal = self._log_joint_term() + self._entropy_term()
        baseline_cost = None
        new_moving_mean = None

        if variance_reduction:
            if baseline is not None:
                baseline = torch.as_tensor(baseline)
                baseline_cost = 0.5 * torch.square(
                    l_signal.detach() - baseline)
                if self._axis is not None:
                    baseline_cost = torch.mean(baseline_cost, dim=self._axis)
                l_signal = l_signal - baseline

            bc = torch.mean(l_signal)
            if moving_mean is not None:
                moving_mean = torch.as_tensor(moving_mean)
                new_moving_mean = (decay * moving_mean
                                   + (1.0 - decay) * bc.detach())
                # Center with the PRE-update mean (reference
                # exclusive_kl.py:215-217): the post-update value holds
                # (1 - decay) of this batch's own signal, which would
                # correlate the baseline with the samples.
                l_signal = l_signal - moving_mean
            else:
                l_signal = l_signal - bc.detach()

        cost = -self._log_joint_term()
        if self._entropy_term() is not None:
            cost = cost + l_signal.detach() * self._entropy_term()
        if self._axis is not None:
            cost = torch.mean(cost, dim=self._axis)

        outputs = (cost,)
        if baseline_cost is not None:
            outputs = outputs + (baseline_cost,)
        if new_moving_mean is not None:
            outputs = outputs + (new_moving_mean,)
        return outputs if len(outputs) > 1 else cost


def elbo(meta_bn, observed, latent=None, axis=None, variational=None):
    """Factory for :class:`EvidenceLowerBoundObjective` (reference
    ``exclusive_kl.py:234-267``).

    :param meta_bn: MetaBayesianNet or log-joint callable.
    :param observed: dict of observations.
    :param latent: ``{name: (samples, log_probs)}`` (exclusive with
        ``variational``).
    :param axis: sample axis to average over.
    :param variational: a BayesianNet variational family.
    """
    return EvidenceLowerBoundObjective(meta_bn, observed, latent=latent,
                                       axis=axis, variational=variational)
