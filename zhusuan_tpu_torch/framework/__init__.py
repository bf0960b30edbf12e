"""The model-building framework (port of ``zhusuan_tpu/framework``).

Ported so far: ``BayesianNet``, ``StochasticTensor``, ``MetaBayesianNet``,
``meta_bayesian_net``, the context stack and the arithmetic mixin.
``marginalize.py`` and ``predictive.py`` come with later slices.
"""

from zhusuan_tpu_torch.framework.arith import TensorArithmeticMixin
from zhusuan_tpu_torch.framework.bn import BayesianNet, StochasticTensor
from zhusuan_tpu_torch.framework.meta_bn import (
    MetaBayesianNet,
    meta_bayesian_net,
)
from zhusuan_tpu_torch.framework.utils import Context, Local, reuse_variables

__all__ = [
    "BayesianNet",
    "Context",
    "Local",
    "MetaBayesianNet",
    "StochasticTensor",
    "TensorArithmeticMixin",
    "meta_bayesian_net",
    "reuse_variables",
]
