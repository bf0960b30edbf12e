"""Legacy framework layer (reference ``zhusuan/legacy/framework/``)."""

from zhusuan_tpu_torch.legacy.framework.stochastic import *  # noqa: F401,F403
from zhusuan_tpu_torch.legacy.framework import stochastic

__all__ = list(stochastic.__all__)
