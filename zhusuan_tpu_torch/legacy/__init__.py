"""Deprecated compatibility layer (port of ``zhusuan_tpu/legacy/``;
reference ``zhusuan/legacy/``).

Old-style self-registering ``StochasticTensor`` wrappers (``zs.Normal('w',
...)`` inside ``with zs.BayesianNet() as bn:``) and the special
``Empirical`` / ``Implicit`` distributions, re-exported flat at the
package's top level as the JAX package does (``zhusuan_tpu/__init__.py:
46-47``). Everything here emits ``FutureWarning`` on use; new code should
use the ``BayesianNet`` sugar methods.
"""

from zhusuan_tpu_torch.legacy import distributions
from zhusuan_tpu_torch.legacy import framework
from zhusuan_tpu_torch.legacy.framework import *  # noqa: F401,F403
from zhusuan_tpu_torch.legacy.framework import stochastic as _stochastic

__all__ = list(_stochastic.__all__)
