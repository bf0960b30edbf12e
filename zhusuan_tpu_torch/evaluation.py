"""Model evaluation (port of ``zhusuan_tpu/evaluation.py``).

Ported so far: :func:`is_loglikelihood`, the importance-sampling estimate
of the marginal log-likelihood that the VAE and SBN examples report. The
JAX module's ``AIS``, ``waic``, ``psis_loo`` and ``compare`` come with a
later slice of the port.
"""

from __future__ import annotations

from zhusuan_tpu_torch.variational.monte_carlo import (
    ImportanceWeightedObjective,
)

__all__ = ["is_loglikelihood"]


def is_loglikelihood(meta_bn, observed, latent=None, axis=None,
                     proposal=None):
    """Marginal log-likelihood estimate by self-normalized importance
    sampling: the importance-weighted objective evaluated as a value
    (reference ``evaluation.py:22-54``).

    :param meta_bn: MetaBayesianNet or log-joint callable.
    :param observed: dict of observations.
    :param latent: ``{name: (samples, log_probs)}`` (exclusive with
        ``proposal``).
    :param axis: the sample axis to reduce (log-mean-exp).
    :param proposal: a BayesianNet proposal whose unobserved stochastic
        nodes provide samples and log-probs.
    :return: the estimated log-likelihood tensor.
    """
    return ImportanceWeightedObjective(
        meta_bn, observed, latent=latent, axis=axis,
        variational=proposal).tensor
