"""Distributions (port of ``zhusuan_tpu/distributions``).

Ported so far: the :class:`Distribution` base, :class:`Normal` and
:class:`MultivariateNormalCholesky` (the SVGP path), :class:`Gamma` (the
positive-support latent of the automatic guides) and :class:`Bernoulli`
(the VAE likelihood and the sigmoid belief nets' layers). The rest of
``univariate.py`` and ``multivariate.py``, and ``extra.py``, ``lkj.py``,
``wishart.py``, ``mixture.py`` and ``flow.py``, come with later slices.
"""

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.multivariate import (
    MultivariateNormalCholesky,
)
from zhusuan_tpu_torch.distributions.univariate import (
    Bernoulli,
    Gamma,
    Normal,
)

__all__ = ["Bernoulli", "Distribution", "Gamma",
           "MultivariateNormalCholesky", "Normal"]
