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
driven by :mod:`.examples.gaussian_process.svgp`; the bijectors
(:mod:`.bijectors`), the automatic guides and one-call ADVI
(:func:`.variational.advi`) with the hand-written CUDA whole-fit trainer
(:func:`.ops.fused_meanfield_advi`), and the standalone CUDA samplers
(:func:`.ops.gpu_normal`, :func:`.ops.gpu_uniform`); ``Bernoulli``, the
importance-weighted objectives (IWAE, DReG, VIMCO), the IS evaluation
(:mod:`.evaluation`) and the packaged training loop (:func:`.fit.fit_scan`),
driven by the VAE, IWAE, SBN, toy2d and BNN examples under :mod:`.examples`;
the rest of the model path (every distribution of ``univariate.py`` and
``multivariate.py`` with its ``BayesianNet`` method, :func:`marginalize`,
:func:`posterior_predictive`), driven by the Gaussian HMC toy, the
Bernoulli-latent, Gumbel-softmax and convolutional VAEs and variational
dropout; the inference-checking toolkit: HMC's windowed warmup
(``HMC.warmup_run``), step-size jitter, ``check_numerics`` and the
step-size search options, split / rank-normalized / nested R-hat,
``summary`` and the kernelized Stein discrepancy (:mod:`.diagnostics`),
AIS, WAIC, PSIS-LOO and ``compare`` (:mod:`.evaluation`), the inclusive KL
and the Renyi / chi upper bounds (:mod:`.variational`), driven by the
evidence-sandwich, LOO-comparison, adaptive-IS SBN and semi-supervised VAE
examples; Gaussian processes (:mod:`.gp`: the kernel zoo, exact regression,
SGPR and the whitened SVGP bound), normalizing flows (:mod:`.transform`:
planar, IAF and affine couplings; ``FlowDistribution``), NeuTra transport
(:func:`.mcmc.fit_neutra`), SVGD (:class:`.variational.SVGD`) and elliptical
slice sampling (:class:`.mcmc.EllipticalSlice`), driven by the GP
regression and classification, flow, SVGD and toy sampler examples; the
Laplace approximation and Pathfinder (:mod:`.variational`, on the port's
copy of ``optax.lbfgs()``), random-walk Metropolis, MALA, slice sampling,
exact discrete Gibbs, block-wise Gibbs and replica exchange (:mod:`.mcmc`),
driven by the change-point example; annealed SMC (:mod:`.smc`) and the
state-space family (:mod:`.ssm`: the particle filter, FFBS, conditional
SMC, particle Gibbs, PMMH, exact HMMs and Kalman filtering with their
log-depth scans), driven by the SMC Bayes-factor and stochastic-volatility
examples; the heads of ``extra.py`` (``StudentT`` to ``VonMises``) and
``Mixture`` with their ``BayesianNet`` methods, driven by the robust,
ordinal and survival regression, eight-schools and Gaussian-mixture
examples, whose NUTS runs take the NUTS kernel through built-in densities
over several latents (:class:`.ops.densities.LatentDictDensity`);
``LKJCholesky``, ``Wishart``, ``Empirical`` and ``Implicit`` with
``BayesianNet.implicit`` / ``empirical``, driven by the covariance
estimation example (NUTS on the kernel through
:class:`.ops.densities.CovarianceEstimationLogJoint`), the matrix
factorization, topic-model and GAN examples; and the deprecated
self-registering wrappers of :mod:`.legacy`, re-exported flat here as the
JAX package does (``zhusuan_tpu_torch.Normal`` is the legacy wrapper); and
the sampler checks of :mod:`.testing` (Geweke, SBC), checkpoints in the JAX
package's npz format (:func:`save_checkpoint`, :func:`restore_checkpoint`),
:mod:`.profiling`, :func:`.ops.checked`, :mod:`.parallel` on
``torch.distributed`` and the data-parallel VAE of
:mod:`.examples.utils.multi_device`. Every module of the JAX package has
its counterpart here.
"""

from zhusuan_tpu_torch import (
    bijectors,
    checkpoint,
    diagnostics,
    distributions,
    evaluation,
    fit,
    framework,
    gp,
    legacy,
    mcmc,
    ops,
    parallel,
    profiling,
    smc,
    ssm,
    testing,
    transform,
    utils,
    variational,
)
from zhusuan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from zhusuan_tpu_torch.fit import fit_scan, make_fit_epoch
from zhusuan_tpu_torch.framework import (
    BayesianNet,
    MetaBayesianNet,
    StochasticTensor,
    marginalize,
    meta_bayesian_net,
    posterior_predictive,
)
from zhusuan_tpu_torch.mcmc import (
    HMC,
    MALA,
    NUTS,
    ChEESHMC,
    ChEESInfo,
    ChEESState,
    DiscreteGibbs,
    DiscreteGibbsInfo,
    DiscreteGibbsState,
    Gibbs,
    GibbsInfo,
    GibbsState,
    HMCInfo,
    HMCState,
    MHInfo,
    MHState,
    NUTSInfo,
    PSGLD,
    REMCInfo,
    REMCState,
    RandomWalkMetropolis,
    ReplicaExchangeHMC,
    SGHMC,
    SGLD,
    SGNHT,
    SGMCMCInfo,
    SGMCMCState,
    SliceInfo,
    SliceSampler,
    SliceState,
    fit_dense_preconditioner,
    whiten_log_joint,
)
from zhusuan_tpu_torch.ops import (
    CovarianceEstimationLogJoint,
    DiagonalGaussianLogJoint,
    EightSchoolsLogJoint,
    EquicorrelatedGaussianLogJoint,
    GaussianLinearRegressionLogJoint,
    LatentDictDensity,
    NealFunnelLogJoint,
    NeuTraLogJoint,
    OrderedLogisticRegressionLogJoint,
    PoissonChangepointLogJoint,
    TemperedLogJoint,
    Toy2DLogJoint,
    WeibullAFTLogJoint,
    WhitenedLogJoint,
    fused_chees_step,
    fused_leapfrog,
    fused_meanfield_advi,
    gpu_normal,
    gpu_uniform,
)
from zhusuan_tpu_torch.legacy import *  # noqa: F401,F403
from zhusuan_tpu_torch.smc import *  # noqa: F401,F403
from zhusuan_tpu_torch.ssm import *  # noqa: F401,F403
from zhusuan_tpu_torch.variational import (
    ADVIResult,
    FullRankGuide,
    MeanFieldGuide,
    advi,
)

__all__ = [
    "BayesianNet",
    "MetaBayesianNet",
    "StochasticTensor",
    "marginalize",
    "meta_bayesian_net",
    "posterior_predictive",
    "ADVIResult",
    "ChEESHMC",
    "ChEESInfo",
    "ChEESState",
    "DiscreteGibbs",
    "DiscreteGibbsInfo",
    "DiscreteGibbsState",
    "Gibbs",
    "GibbsInfo",
    "GibbsState",
    "HMC",
    "HMCInfo",
    "HMCState",
    "MALA",
    "MHInfo",
    "MHState",
    "NUTS",
    "NUTSInfo",
    "PSGLD",
    "REMCInfo",
    "REMCState",
    "RandomWalkMetropolis",
    "ReplicaExchangeHMC",
    "SGHMC",
    "SGLD",
    "SGMCMCInfo",
    "SGMCMCState",
    "SGNHT",
    "SliceInfo",
    "SliceSampler",
    "SliceState",
    "CovarianceEstimationLogJoint",
    "DiagonalGaussianLogJoint",
    "EightSchoolsLogJoint",
    "EquicorrelatedGaussianLogJoint",
    "GaussianLinearRegressionLogJoint",
    "LatentDictDensity",
    "NealFunnelLogJoint",
    "NeuTraLogJoint",
    "OrderedLogisticRegressionLogJoint",
    "PoissonChangepointLogJoint",
    "FullRankGuide",
    "MeanFieldGuide",
    "TemperedLogJoint",
    "Toy2DLogJoint",
    "WeibullAFTLogJoint",
    "WhitenedLogJoint",
    "advi",
    "fit_dense_preconditioner",
    "fit_scan",
    "fused_chees_step",
    "fused_leapfrog",
    "fused_meanfield_advi",
    "gpu_normal",
    "gpu_uniform",
    "make_fit_epoch",
    "restore_checkpoint",
    "save_checkpoint",
    "whiten_log_joint",
] + smc.__all__ + ssm.__all__ + legacy.__all__ + [
    "bijectors",
    "checkpoint",
    "diagnostics",
    "distributions",
    "evaluation",
    "fit",
    "framework",
    "gp",
    "legacy",
    "mcmc",
    "ops",
    "parallel",
    "profiling",
    "smc",
    "ssm",
    "testing",
    "transform",
    "utils",
    "variational",
]
