"""Legacy distributions (reference ``zhusuan/legacy/distributions/``)."""

from zhusuan_tpu_torch.legacy.distributions.special import *  # noqa: F401,F403
from zhusuan_tpu_torch.legacy.distributions import special

__all__ = list(special.__all__)
