"""Distributions (port of ``zhusuan_tpu/distributions``).

Ported so far: the :class:`Distribution` base, all fourteen names of
``univariate.py`` and all thirteen of ``multivariate.py`` (the JAX
package's ``MultivariateStudentTCholesky`` among them), under the JAX
names, aliases included, and ``flow.py``'s :class:`FlowDistribution`.
``extra.py``, ``lkj.py``, ``wishart.py``, ``mixture.py`` and ``special.py``
are not ported yet.
"""

from zhusuan_tpu_torch.distributions import utils  # noqa: F401
from zhusuan_tpu_torch.distributions import multivariate as _multi
from zhusuan_tpu_torch.distributions import univariate as _uni
from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.flow import FlowDistribution
from zhusuan_tpu_torch.distributions.multivariate import *  # noqa: F401,F403
from zhusuan_tpu_torch.distributions.univariate import *  # noqa: F401,F403

__all__ = (["Distribution", "FlowDistribution"] + _uni.__all__
           + _multi.__all__)
