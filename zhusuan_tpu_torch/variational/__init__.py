"""Variational inference (port of ``zhusuan_tpu/variational``).

Ported so far: the :class:`VariationalObjective` base, the ELBO
(:func:`elbo`, ``sgvb`` and ``reinforce``), the importance-weighted
objective (:func:`importance_weighted_objective`: IWAE ``sgvb``, ``dreg``
and ``vimco``), the inclusive KL (:func:`klpq`), the Renyi and chi upper
bounds (:func:`vr_objective`, :func:`cubo_objective`), the automatic guides
(:class:`MeanFieldGuide`, :class:`FullRankGuide`), one-call ADVI
(:func:`advi`), Stein variational gradient descent (:class:`SVGD`), the
Laplace approximation (:func:`laplace_approximation`) and Pathfinder
(:func:`pathfinder`, :func:`multipath_pathfinder`,
:func:`pathfinder_mcmc_init`), both on the port's copy of ``optax.lbfgs()``
(:mod:`._lbfgs`). Every module of the JAX package's ``variational`` is
ported.
"""

from zhusuan_tpu_torch.variational.advi import (
    ADVIResult,
    advi,
    cosine_decay_schedule,
)
from zhusuan_tpu_torch.variational.autoguide import (
    FullRankGuide,
    MeanFieldGuide,
    params_from_numpy,
    params_to_numpy,
)
from zhusuan_tpu_torch.variational.base import VariationalObjective
from zhusuan_tpu_torch.variational.exclusive_kl import (
    EvidenceLowerBoundObjective,
    elbo,
)
from zhusuan_tpu_torch.variational.inclusive_kl import (
    InclusiveKLObjective,
    klpq,
)
from zhusuan_tpu_torch.variational.monte_carlo import (
    ImportanceWeightedObjective,
    importance_weighted_objective,
    iw_objective,
)
from zhusuan_tpu_torch.variational.laplace import (
    LaplaceResult,
    laplace_approximation,
)
from zhusuan_tpu_torch.variational.pathfinder import (
    MultiPathfinderResult,
    PathfinderResult,
    multipath_pathfinder,
    pathfinder,
    pathfinder_mcmc_init,
)
from zhusuan_tpu_torch.variational.svgd import SVGD, SVGDInfo, SVGDState
from zhusuan_tpu_torch.variational.renyi import (
    ChiSquareObjective,
    RenyiDivergenceObjective,
    cubo_objective,
    vr_objective,
)

__all__ = ["ADVIResult", "ChiSquareObjective", "EvidenceLowerBoundObjective",
           "FullRankGuide", "ImportanceWeightedObjective",
           "InclusiveKLObjective", "LaplaceResult", "MeanFieldGuide",
           "MultiPathfinderResult", "PathfinderResult",
           "RenyiDivergenceObjective", "SVGD", "SVGDInfo", "SVGDState",
           "VariationalObjective", "advi",
           "cosine_decay_schedule", "cubo_objective", "elbo",
           "importance_weighted_objective", "iw_objective", "klpq",
           "laplace_approximation", "multipath_pathfinder", "pathfinder",
           "pathfinder_mcmc_init",
           "params_from_numpy", "params_to_numpy", "vr_objective"]
