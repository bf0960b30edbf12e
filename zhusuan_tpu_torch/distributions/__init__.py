"""Distributions (port of ``zhusuan_tpu/distributions``).

Every module is ported, under the JAX names, aliases included: the
:class:`Distribution` base, all fourteen names of ``univariate.py`` and all
thirteen of ``multivariate.py`` (the JAX package's
``MultivariateStudentTCholesky`` among them), all thirteen of ``extra.py``,
``mixture.py``'s :class:`Mixture`, ``flow.py``'s :class:`FlowDistribution`,
``lkj.py``'s :class:`LKJCholesky`, ``wishart.py``'s :class:`Wishart` and
``special.py``'s :class:`Empirical` and :class:`Implicit`.
"""

from zhusuan_tpu_torch.distributions import utils  # noqa: F401
from zhusuan_tpu_torch.distributions import extra as _extra
from zhusuan_tpu_torch.distributions import multivariate as _multi
from zhusuan_tpu_torch.distributions import univariate as _uni
from zhusuan_tpu_torch.distributions.base import Distribution
from zhusuan_tpu_torch.distributions.extra import *  # noqa: F401,F403
from zhusuan_tpu_torch.distributions.flow import FlowDistribution
from zhusuan_tpu_torch.distributions.lkj import LKJCholesky
from zhusuan_tpu_torch.distributions.mixture import Mixture
from zhusuan_tpu_torch.distributions.multivariate import *  # noqa: F401,F403
from zhusuan_tpu_torch.distributions.special import Empirical, Implicit
from zhusuan_tpu_torch.distributions.univariate import *  # noqa: F401,F403
from zhusuan_tpu_torch.distributions.wishart import Wishart

__all__ = (["Distribution", "FlowDistribution", "Mixture", "LKJCholesky",
            "Wishart", "Empirical", "Implicit"] + _uni.__all__
           + _multi.__all__ + _extra.__all__)
