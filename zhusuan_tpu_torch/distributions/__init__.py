"""Distributions (port of ``zhusuan_tpu/distributions``).

Ported so far: the :class:`Distribution` base, :class:`Normal` and
:class:`MultivariateNormalCholesky`, the distributions of the SVGP path, and
:class:`Gamma`, the positive-support latent of the automatic guides.
"""

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.multivariate import (
    MultivariateNormalCholesky,
)
from zhusuan_tpu_torch.distributions.univariate import Gamma, Normal

__all__ = ["Distribution", "Gamma", "MultivariateNormalCholesky", "Normal"]
