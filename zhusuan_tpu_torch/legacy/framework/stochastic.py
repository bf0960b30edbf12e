"""Deprecated self-registering ``StochasticTensor`` wrapper classes.

Port of ``zhusuan_tpu/legacy/framework/stochastic.py`` (reference
``zhusuan/legacy/framework/stochastic.py``): one wrapper class a
distribution (Normal :47, FoldNormal :105, Bernoulli :163, Categorical
:208, Uniform :260, Gamma :310, Beta :355, Poisson :402, Binomial :448,
MultivariateNormalCholesky :500, MatrixVariateNormalCholesky :555,
Multinomial :620, UnnormalizedMultinomial :685, OnehotCategorical :750,
Dirichlet :803, InverseGamma :852, Laplace :897, BinConcrete :947,
ExpConcrete :1007, Concrete :1067, Empirical :1128, Implicit :1179) and the
aliases (Discrete, OnehotDiscrete, BagofCategoricals, *GumbelSoftmax). Each
builds its distribution, finds the ambient ``BayesianNet`` context to
register itself in and pick up its observation
(``BayesianNet._get_observation``), and emits a ``FutureWarning``.

Sampling: inside a net built with ``BayesianNet(key=...)`` a node draws
from the net's generator for its name, as a modern node does. A standalone
wrapper (no ambient net) takes ``key=``, an int seed: its generator is
seeded by :func:`~zhusuan_tpu_torch.framework.bn.node_seed` of the key and
its name, the counterpart of the JAX package's ``fold_in(key,
crc32(name))``. ``Implicit`` and ``Empirical`` need no key.
"""

from __future__ import annotations

import warnings

import torch

from zhusuan_tpu_torch import distributions
from zhusuan_tpu_torch.distributions import special as _special
from zhusuan_tpu_torch.framework.bn import (
    BayesianNet,
    StochasticTensor,
    node_seed,
)

__all__ = [
    "Normal",
    "FoldNormal",
    "Bernoulli",
    "Categorical",
    "OnehotCategorical",
    "Discrete",
    "OnehotDiscrete",
    "Uniform",
    "Gamma",
    "Beta",
    "Poisson",
    "Binomial",
    "InverseGamma",
    "Laplace",
    "MultivariateNormalCholesky",
    "MatrixVariateNormalCholesky",
    "Multinomial",
    "UnnormalizedMultinomial",
    "BagofCategoricals",
    "Dirichlet",
    "BinConcrete",
    "BinGumbelSoftmax",
    "ExpConcrete",
    "ExpGumbelSoftmax",
    "Concrete",
    "GumbelSoftmax",
    "Empirical",
    "Implicit",
]

_DEPRECATION_MESSAGE = (
    "The old-style StochasticTensor wrappers will be removed in a future "
    "version. Please see the concepts tutorial for the suggested way of "
    "model construction."
)


class _LegacyStochasticTensor(StochasticTensor):
    """Base of the deprecated wrappers: warns, registers itself in the
    ambient ``BayesianNet`` context and picks up its observation from the
    net's observation dict (reference framework/bn.py:68-94)."""

    def __init__(self, name, dist, n_samples=None, key=None):
        warnings.warn(_DEPRECATION_MESSAGE, FutureWarning)
        bn = BayesianNet.try_get_context()
        observation = bn._get_observation(name) if bn is not None else None
        super().__init__(bn, name, dist, observation=observation,
                         n_samples=n_samples)
        self._legacy_key = key
        if bn is not None:
            bn._register_node(name, self)

    @property
    def tensor(self):
        if self._observation is None and self._tensor is None:
            if self._legacy_key is not None:
                generator = torch.Generator(
                    device=self._dist.device).manual_seed(
                        node_seed(self._legacy_key, self._name))
                self._tensor = self._dist.sample(
                    generator, n_samples=self._n_samples)
            elif self._bn is None:
                if isinstance(self._dist,
                              (_special.Implicit, _special.Empirical)):
                    # Key-free: Implicit "samples" its wrapped tensor as it
                    # is; Empirical raises its own error (reference
                    # legacy/distributions/special.py:60,151).
                    self._tensor = self._dist.sample(
                        None, n_samples=self._n_samples)
                else:
                    raise ValueError(
                        "Legacy node '{}' is unobserved, has no enclosing "
                        "BayesianNet context, and no explicit key. Pass "
                        "`key=` to the wrapper, or construct it inside "
                        "`with BayesianNet(key=...):`.".format(self._name))
        return StochasticTensor.tensor.fget(self)


def _make_wrapper(class_name, dist_cls, ref_line):
    """One deprecated wrapper class around ``dist_cls``, with the signature
    ``(name, *dist_args, n_samples=None, key=None, **dist_kwargs)``: the
    distribution's parameters pass through as they are."""

    def __init__(self, name, *args, n_samples=None, key=None, **kwargs):
        dist = dist_cls(*args, **kwargs)
        _LegacyStochasticTensor.__init__(self, name, dist,
                                         n_samples=n_samples, key=key)

    return type(class_name, (_LegacyStochasticTensor,), {
        "__init__": __init__,
        "__doc__": (
            "Deprecated {0} StochasticTensor wrapper (reference "
            "legacy/framework/stochastic.py:{1}). Signature: ``{0}(name, "
            "<{0} distribution parameters>, n_samples=None, key=None)``; "
            "see :class:`zhusuan_tpu_torch.distributions.{0}`.".format(
                class_name, ref_line)),
    })


Normal = _make_wrapper("Normal", distributions.Normal, 47)
FoldNormal = _make_wrapper("FoldNormal", distributions.FoldNormal, 105)
Bernoulli = _make_wrapper("Bernoulli", distributions.Bernoulli, 163)
Categorical = _make_wrapper("Categorical", distributions.Categorical, 208)
Discrete = Categorical
Uniform = _make_wrapper("Uniform", distributions.Uniform, 260)
Gamma = _make_wrapper("Gamma", distributions.Gamma, 310)
Beta = _make_wrapper("Beta", distributions.Beta, 355)
Poisson = _make_wrapper("Poisson", distributions.Poisson, 402)
Binomial = _make_wrapper("Binomial", distributions.Binomial, 448)
MultivariateNormalCholesky = _make_wrapper(
    "MultivariateNormalCholesky",
    distributions.MultivariateNormalCholesky, 500)
MatrixVariateNormalCholesky = _make_wrapper(
    "MatrixVariateNormalCholesky",
    distributions.MatrixVariateNormalCholesky, 555)
Multinomial = _make_wrapper("Multinomial", distributions.Multinomial, 620)
UnnormalizedMultinomial = _make_wrapper(
    "UnnormalizedMultinomial", distributions.UnnormalizedMultinomial, 685)
BagofCategoricals = UnnormalizedMultinomial
OnehotCategorical = _make_wrapper(
    "OnehotCategorical", distributions.OnehotCategorical, 750)
OnehotDiscrete = OnehotCategorical
Dirichlet = _make_wrapper("Dirichlet", distributions.Dirichlet, 803)
InverseGamma = _make_wrapper("InverseGamma", distributions.InverseGamma, 852)
Laplace = _make_wrapper("Laplace", distributions.Laplace, 897)
BinConcrete = _make_wrapper("BinConcrete", distributions.BinConcrete, 947)
BinGumbelSoftmax = BinConcrete
ExpConcrete = _make_wrapper("ExpConcrete", distributions.ExpConcrete, 1007)
ExpGumbelSoftmax = ExpConcrete
Concrete = _make_wrapper("Concrete", distributions.Concrete, 1067)
GumbelSoftmax = Concrete
Empirical = _make_wrapper("Empirical", _special.Empirical, 1128)
Implicit = _make_wrapper("Implicit", _special.Implicit, 1179)
