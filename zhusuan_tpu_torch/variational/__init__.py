"""Variational inference (port of ``zhusuan_tpu/variational``).

Ported so far: the :class:`VariationalObjective` base, the ELBO
(:func:`elbo`, ``sgvb`` and ``reinforce``), the automatic guides
(:class:`MeanFieldGuide`, :class:`FullRankGuide`) and one-call ADVI
(:func:`advi`). ``monte_carlo.py``, ``inclusive_kl.py``, ``renyi.py``,
``laplace.py``, ``pathfinder.py`` and ``svgd.py`` come with later slices.
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

__all__ = ["ADVIResult", "EvidenceLowerBoundObjective", "FullRankGuide",
           "MeanFieldGuide", "VariationalObjective", "advi",
           "cosine_decay_schedule", "elbo", "params_from_numpy",
           "params_to_numpy"]
