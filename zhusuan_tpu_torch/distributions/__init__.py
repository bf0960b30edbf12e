"""Distributions (port of ``zhusuan_tpu/distributions``).

Ported so far: the :class:`Distribution` base, :class:`Normal` and
:class:`MultivariateNormalCholesky`, the distributions of the SVGP path.
"""

from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.multivariate import (
    MultivariateNormalCholesky,
)
from zhusuan_tpu_torch.distributions.univariate import Normal

__all__ = ["Distribution", "MultivariateNormalCholesky", "Normal"]
