"""MCMC samplers of the port (counterpart of ``zhusuan_tpu/mcmc``).

Ported so far: :class:`HMC` with its shared machinery (:mod:`.base`),
:class:`NUTS`, :class:`ChEESHMC`, dense preconditioning
(:func:`fit_dense_preconditioner`, :func:`whiten_log_joint`) and the
stochastic-gradient samplers :class:`SGLD`, :class:`PSGLD`, :class:`SGHMC`
and :class:`SGNHT` (:mod:`.sgmcmc`), NeuTra transport
(:func:`fit_neutra`, :func:`neutra_log_joint`) and elliptical slice
sampling (:class:`EllipticalSlice`), random-walk Metropolis and MALA
(:mod:`.rwm`), coordinate-wise slice sampling (:class:`SliceSampler`),
exact discrete Gibbs (:class:`DiscreteGibbs`), block-wise Gibbs
(:class:`Gibbs`) and replica exchange (:class:`ReplicaExchangeHMC`): every
module of the JAX package's ``mcmc``.
"""

from zhusuan_tpu_torch.mcmc.chees import ChEESHMC, ChEESInfo, ChEESState
from zhusuan_tpu_torch.mcmc.discrete import (
    DiscreteGibbs,
    DiscreteGibbsInfo,
    DiscreteGibbsState,
)
from zhusuan_tpu_torch.mcmc.elliptical import (
    EllipticalSlice,
    EllipticalSliceInfo,
    EllipticalSliceState,
)
from zhusuan_tpu_torch.mcmc.gibbs import Gibbs, GibbsInfo, GibbsState
from zhusuan_tpu_torch.mcmc.hmc import (
    HMC,
    HMCInfo,
    HMCState,
    state_from_numpy,
    state_to_numpy,
)
from zhusuan_tpu_torch.mcmc.neutra import (
    NeuTraResult,
    fit_neutra,
    neutra_log_joint,
)
from zhusuan_tpu_torch.mcmc.nuts import NUTS, NUTSInfo
from zhusuan_tpu_torch.mcmc.precondition import (
    fit_dense_preconditioner,
    whiten_log_joint,
)
from zhusuan_tpu_torch.mcmc.remc import (
    REMCInfo,
    REMCState,
    ReplicaExchangeHMC,
)
from zhusuan_tpu_torch.mcmc.rwm import (
    MALA,
    MHInfo,
    MHState,
    RandomWalkMetropolis,
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
from zhusuan_tpu_torch.mcmc.slice_sampler import (
    SliceInfo,
    SliceSampler,
    SliceState,
)

__all__ = ["ChEESHMC", "ChEESInfo", "ChEESState", "DiscreteGibbs",
           "DiscreteGibbsInfo", "DiscreteGibbsState", "EllipticalSlice",
           "EllipticalSliceInfo", "EllipticalSliceState", "Gibbs",
           "GibbsInfo", "GibbsState", "HMC", "HMCInfo", "HMCState", "MALA",
           "MHInfo", "MHState", "NUTS", "NUTSInfo", "NeuTraResult", "PSGLD",
           "REMCInfo", "REMCState", "RandomWalkMetropolis",
           "ReplicaExchangeHMC", "SGHMC", "SGLD", "SGMCMC", "SGMCMCInfo",
           "SGMCMCState", "SGNHT", "SliceInfo", "SliceSampler", "SliceState",
           "fit_dense_preconditioner", "fit_neutra", "neutra_log_joint",
           "state_from_numpy", "state_to_numpy", "whiten_log_joint"]
