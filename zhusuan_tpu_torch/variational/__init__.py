"""Variational inference (port of ``zhusuan_tpu/variational``).

Ported so far: the :class:`VariationalObjective` base and the ELBO
(:func:`elbo`, ``sgvb`` and ``reinforce``). ``monte_carlo.py``,
``inclusive_kl.py`` and ``renyi.py`` come with later slices.
"""

from zhusuan_tpu_torch.variational.base import VariationalObjective
from zhusuan_tpu_torch.variational.exclusive_kl import (
    EvidenceLowerBoundObjective,
    elbo,
)

__all__ = ["EvidenceLowerBoundObjective", "VariationalObjective", "elbo"]
