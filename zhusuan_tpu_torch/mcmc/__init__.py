"""MCMC samplers of the port (counterpart of ``zhusuan_tpu/mcmc``).

Ported so far: :class:`HMC` with its shared machinery (:mod:`.base`) and
:class:`NUTS`.
"""

from zhusuan_tpu_torch.mcmc.hmc import (
    HMC,
    HMCInfo,
    HMCState,
    state_from_numpy,
    state_to_numpy,
)
from zhusuan_tpu_torch.mcmc.nuts import NUTS, NUTSInfo

__all__ = ["HMC", "HMCInfo", "HMCState", "NUTS", "NUTSInfo",
           "state_from_numpy", "state_to_numpy"]
