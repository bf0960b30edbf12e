"""MCMC samplers of the port (counterpart of ``zhusuan_tpu/mcmc``).

Ported so far: :class:`HMC` with its shared machinery (:mod:`.base`),
:class:`NUTS`, :class:`ChEESHMC`, dense preconditioning
(:func:`fit_dense_preconditioner`, :func:`whiten_log_joint`) and the
stochastic-gradient samplers :class:`SGLD`, :class:`PSGLD`, :class:`SGHMC`
and :class:`SGNHT` (:mod:`.sgmcmc`).
"""

from zhusuan_tpu_torch.mcmc.chees import ChEESHMC, ChEESInfo, ChEESState
from zhusuan_tpu_torch.mcmc.hmc import (
    HMC,
    HMCInfo,
    HMCState,
    state_from_numpy,
    state_to_numpy,
)
from zhusuan_tpu_torch.mcmc.nuts import NUTS, NUTSInfo
from zhusuan_tpu_torch.mcmc.precondition import (
    fit_dense_preconditioner,
    whiten_log_joint,
)
from zhusuan_tpu_torch.mcmc.sgmcmc import (
    PSGLD,
    SGHMC,
    SGLD,
    SGMCMC,
    SGNHT,
    SGMCMCInfo,
    SGMCMCState,
)

__all__ = ["ChEESHMC", "ChEESInfo", "ChEESState", "HMC", "HMCInfo",
           "HMCState", "NUTS", "NUTSInfo", "PSGLD", "SGHMC", "SGLD",
           "SGMCMC", "SGMCMCInfo", "SGMCMCState", "SGNHT",
           "fit_dense_preconditioner", "state_from_numpy", "state_to_numpy",
           "whiten_log_joint"]
