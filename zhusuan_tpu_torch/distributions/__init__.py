"""Distributions (port of ``zhusuan_tpu/distributions``).

Ported so far: the :class:`Distribution` base, all fourteen names of
``univariate.py`` and all thirteen of ``multivariate.py`` (the JAX
package's ``MultivariateStudentTCholesky`` among them), under the JAX
names, aliases included, all thirteen of ``extra.py``, ``mixture.py``'s
:class:`Mixture` and ``flow.py``'s :class:`FlowDistribution`. ``lkj.py``,
``wishart.py`` and ``special.py`` are not ported yet.
"""

from zhusuan_tpu_torch.distributions import utils  # noqa: F401
from zhusuan_tpu_torch.distributions import extra as _extra
from zhusuan_tpu_torch.distributions import multivariate as _multi
from zhusuan_tpu_torch.distributions import univariate as _uni
from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.extra import *  # noqa: F401,F403
from zhusuan_tpu_torch.distributions.flow import FlowDistribution
from zhusuan_tpu_torch.distributions.mixture import Mixture
from zhusuan_tpu_torch.distributions.multivariate import *  # noqa: F401,F403
from zhusuan_tpu_torch.distributions.univariate import *  # noqa: F401,F403

__all__ = (["Distribution", "FlowDistribution", "Mixture"] + _uni.__all__
           + _multi.__all__ + _extra.__all__)
