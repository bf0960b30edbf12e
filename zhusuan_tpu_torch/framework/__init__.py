"""The model-building framework (port of ``zhusuan_tpu/framework``).

Ported: ``BayesianNet``, ``StochasticTensor``, ``MetaBayesianNet``,
``meta_bayesian_net``, the context stack, the arithmetic mixin,
``marginalize`` and ``posterior_predictive``.
"""

from zhusuan_tpu_torch.framework.arith import TensorArithmeticMixin
from zhusuan_tpu_torch.framework.bn import BayesianNet, StochasticTensor
from zhusuan_tpu_torch.framework.marginalize import marginalize
from zhusuan_tpu_torch.framework.meta_bn import (
    MetaBayesianNet,
    meta_bayesian_net,
)
from zhusuan_tpu_torch.framework.predictive import posterior_predictive
from zhusuan_tpu_torch.framework.utils import (
    Context,
    Local,
    reuse,
    reuse_variables,
)

__all__ = [
    "BayesianNet",
    "Context",
    "Local",
    "MetaBayesianNet",
    "StochasticTensor",
    "TensorArithmeticMixin",
    "marginalize",
    "meta_bayesian_net",
    "posterior_predictive",
    "reuse",
    "reuse_variables",
]
