"""ZhuSuan on PyTorch and CUDA: the port of ``zhusuan_tpu`` to an NVIDIA
H100.

Imports ``torch`` and never ``jax``. Module names mirror ``zhusuan_tpu``.
Ported so far: adaptive HMC, NUTS, ChEES-HMC and the stochastic-gradient
samplers SGLD, PSGLD, SGHMC and SGNHT, each with its hand-written CUDA
transition kernel, and dense preconditioning (:mod:`.mcmc`, :mod:`.ops`),
the ESS diagnostics (:mod:`.diagnostics`) and the utilities they use
(:mod:`.utils`); the model path of the SVGP example (:mod:`.framework`:
``BayesianNet``, ``MetaBayesianNet``; :mod:`.distributions`: ``Normal``,
``MultivariateNormalCholesky``), the ELBO (:mod:`.variational`) and the
hand-written CUDA Cholesky-plus-inverse kernel (:func:`.ops.cholesky_inverse`),
driven by :mod:`.examples.gaussian_process.svgp`.
"""

from zhusuan_tpu_torch import (
    diagnostics,
    distributions,
    framework,
    mcmc,
    ops,
    utils,
    variational,
)
from zhusuan_tpu_torch.framework import (
    BayesianNet,
    MetaBayesianNet,
    StochasticTensor,
    meta_bayesian_net,
)
from zhusuan_tpu_torch.mcmc import (
    HMC,
    NUTS,
    ChEESHMC,
    ChEESInfo,
    ChEESState,
    HMCInfo,
    HMCState,
    NUTSInfo,
    PSGLD,
    SGHMC,
    SGLD,
    SGNHT,
    SGMCMCInfo,
    SGMCMCState,
    fit_dense_preconditioner,
    whiten_log_joint,
)
from zhusuan_tpu_torch.ops import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
    fused_chees_step,
    fused_leapfrog,
)

__all__ = [
    "BayesianNet",
    "MetaBayesianNet",
    "StochasticTensor",
    "meta_bayesian_net",
    "ChEESHMC",
    "ChEESInfo",
    "ChEESState",
    "HMC",
    "HMCInfo",
    "HMCState",
    "NUTS",
    "NUTSInfo",
    "PSGLD",
    "SGHMC",
    "SGLD",
    "SGMCMCInfo",
    "SGMCMCState",
    "SGNHT",
    "DiagonalGaussianLogJoint",
    "EquicorrelatedGaussianLogJoint",
    "fit_dense_preconditioner",
    "fused_chees_step",
    "fused_leapfrog",
    "whiten_log_joint",
    "diagnostics",
    "distributions",
    "framework",
    "mcmc",
    "ops",
    "utils",
    "variational",
]
