"""Legacy import path of the special distributions (reference
``zhusuan/legacy/distributions/special.py``): the classes live in
:mod:`zhusuan_tpu_torch.distributions.special`, as in the JAX package."""

from zhusuan_tpu_torch.distributions.special import Empirical, Implicit

__all__ = ["Empirical", "Implicit"]
