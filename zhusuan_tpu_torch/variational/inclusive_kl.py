"""Inclusive KL divergence objective KL(p || q).

Port of ``zhusuan_tpu/variational/inclusive_kl.py`` (parity: reference
``zhusuan/variational/inclusive_kl.py``): ``InclusiveKLObjective``
(:24-151), whose value cannot be evaluated (:101-104), the self-normalized
importance-sampling gradient ``importance`` (the Reweighted Wake-Sleep
wake-phase proposal update, :116-151) with its deprecated alias ``rws``,
and the ``klpq`` factory (:154-187). ``stop_gradient`` is ``detach``.
"""

from __future__ import annotations

import warnings

import torch

from zhusuan_tpu_torch.variational.base import VariationalObjective

__all__ = ["InclusiveKLObjective", "klpq"]


class InclusiveKLObjective(VariationalObjective):
    """The inclusive KL objective KL(p || q): minimizing it drives the
    variational posterior to cover the true posterior's mass. It can only
    be optimized, not evaluated.

    :param axis: the sample axis the self-normalized weights run over;
        None uses a single sample (biased; warns).
    """

    def __init__(self, meta_bn, observed, latent=None, axis=None,
                 variational=None):
        self._axis = axis
        super().__init__(meta_bn, observed, latent=latent,
                         variational=variational)

    def _objective(self):
        raise NotImplementedError(
            "The inclusive KL objective (klpq) can only be optimized instead "
            "of being evaluated. (Parity: reference inclusive_kl.py:101-104.)"
        )

    def rws(self):
        """(Deprecated) alias of :meth:`importance` (reference
        inclusive_kl.py:106-114)."""
        warnings.warn(
            "The `rws()` method has been renamed to `importance()`; "
            "`rws()` is kept only for reference compatibility.",
            FutureWarning,
        )
        return self.importance()

    def importance(self):
        """Self-normalized importance-sampling gradient estimator for the
        proposal (Reweighted Wake-Sleep wake-phase q update, Bornschein
        2015; reference ``inclusive_kl.py:116-151``): the detached
        normalized weights times the entropy term, summed over ``axis``.
        Only the entropy term carries a gradient; with ``axis=None`` the
        single-sample estimator is returned with a bias warning.
        """
        entropy = self._entropy_term()
        if self._axis is not None:
            axis = self._axis
            log_w = (self._log_joint_term() + entropy).detach()
            log_w_max = torch.amax(log_w, dim=axis, keepdim=True)
            w_u = torch.exp(log_w - log_w_max)
            w_tilde = w_u / torch.sum(w_u, dim=axis, keepdim=True)
            return torch.sum(w_tilde * entropy, dim=axis)
        warnings.warn(
            "The gradient estimator is using self-normalized importance "
            "sampling, which is heavily biased and inaccurate when "
            "you're using only a single sample (`axis=None`).")
        return entropy


def klpq(meta_bn, observed, latent=None, axis=None, variational=None):
    """Factory for :class:`InclusiveKLObjective` (reference
    inclusive_kl.py:154-187).

    :param meta_bn: MetaBayesianNet or log-joint callable.
    :param observed: dict of observations.
    :param latent: ``{name: (samples, log_probs)}`` (exclusive with
        ``variational``).
    :param axis: the sample axis of the self-normalized weights.
    :param variational: a BayesianNet proposal.
    """
    return InclusiveKLObjective(meta_bn, observed, latent=latent, axis=axis,
                                variational=variational)
