"""Base class for variational objectives.

Port of ``zhusuan_tpu/variational/base.py`` (parity: reference
``zhusuan/variational/base.py``, ``VariationalObjective``,
base.py:24-196): accepts a :class:`MetaBayesianNet` *or* a raw
``log_joint(obs_dict)`` callable; the variational posterior is either a
:class:`BayesianNet` (``variational=``) whose unobserved stochastic nodes
contribute samples and log-probs (base.py:63-73), or a
``latent={name: (samples, log_probs)}`` dict (base.py:74-85).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from zhusuan_tpu_torch.framework.arith import TensorArithmeticMixin, unwrap
from zhusuan_tpu_torch.framework.bn import BayesianNet, StochasticTensor
from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet
from zhusuan_tpu_torch.utils import merge_dicts

__all__ = ["VariationalObjective"]


class VariationalObjective(TensorArithmeticMixin):
    """Base class for variational objectives.

    :param meta_bn: a :class:`MetaBayesianNet` or a callable
        ``log_joint(observed_dict) -> tensor``.
    :param observed: dict of observed node names to values.
    :param latent: dict ``{name: (samples, log_probs)}``; mutually exclusive
        with ``variational``.
    :param variational: a :class:`BayesianNet` defining the variational
        family; its *unobserved* stochastic nodes become the latent inputs.
    """

    def __init__(
        self,
        meta_bn: Union[MetaBayesianNet, Callable],
        observed: Dict,
        latent: Optional[Dict] = None,
        variational: Optional[BayesianNet] = None,
    ):
        if isinstance(meta_bn, MetaBayesianNet):
            self._meta_bn = meta_bn
            self._log_joint_fn = None
        elif callable(meta_bn):
            self._meta_bn = None
            self._log_joint_fn = meta_bn
        else:
            raise TypeError(
                "`meta_bn` should be a MetaBayesianNet instance or a callable "
                "log joint function, got {!r}.".format(type(meta_bn)))

        if (variational is None) == (latent is None):
            raise ValueError(
                "Exactly one of `variational` and `latent` should be passed.")

        if variational is not None:
            if not isinstance(variational, BayesianNet):
                raise TypeError(
                    "`variational` should be a BayesianNet instance, got "
                    "{!r}.".format(type(variational)))
            v_names = [
                name for name, node in variational.nodes.items()
                if isinstance(node, StochasticTensor) and not node.is_observed
            ]
            self._v_inputs = {name: variational.nodes[name].tensor
                              for name in v_names}
            self._v_log_probs = {name: variational.nodes[name].cond_log_p
                                 for name in v_names}
            self._v_nodes = {name: variational.nodes[name]
                             for name in v_names}
        else:
            self._v_nodes = None
            for name, value in latent.items():
                if not (isinstance(value, (tuple, list)) and len(value) == 2):
                    raise ValueError(
                        "latent[{!r}] should be a (samples, log_probs) "
                        "pair.".format(name))
            self._v_inputs = {k: torch.as_tensor(unwrap(v[0]))
                              for k, v in latent.items()}
            self._v_log_probs = {k: torch.as_tensor(unwrap(v[1]))
                                 for k, v in latent.items()}

        self._observed = dict(observed)
        self._joint_obs = merge_dicts(self._v_inputs, self._observed)
        self._bn_cache = None
        self._log_joint_cache = None
        self._entropy_cache = None
        self._tensor_cache = None

    @property
    def meta_bn(self):
        return self._meta_bn

    @property
    def variational_inputs(self):
        """Dict of latent names to their (sampled) values."""
        return self._v_inputs

    @property
    def bn(self) -> BayesianNet:
        """The model instantiated by observing the variational samples plus
        the observations; every stochastic node must be covered (reference
        base.py:91-97,118-138)."""
        if self._meta_bn is None:
            raise ValueError(
                "The `bn` property is only available when `meta_bn` is a "
                "MetaBayesianNet (not a raw log-joint function).")
        if self._bn_cache is None:
            bn = self._meta_bn.observe(**self._joint_obs)
            uncovered = [
                name for name, node in bn.nodes.items()
                if isinstance(node, StochasticTensor) and not node.is_observed
            ]
            if uncovered:
                raise ValueError(
                    "Stochastic nodes {} are neither observed nor covered by "
                    "the variational posterior.".format(uncovered))
            self._bn_cache = bn
        return self._bn_cache

    def _log_joint_term(self):
        if self._log_joint_cache is None:
            if self._log_joint_fn is not None:
                self._log_joint_cache = self._log_joint_fn(self._joint_obs)
            else:
                self._log_joint_cache = self.bn.log_joint()
        return self._log_joint_cache

    def _log_joint_at(self, joint_obs):
        """The model log-joint at another observation dict (no caching), for
        estimators that need a second model pass."""
        if self._log_joint_fn is not None:
            return self._log_joint_fn(joint_obs)
        return self._meta_bn.observe(**joint_obs).log_joint()

    def _entropy_term(self):
        """Negative sum of variational log-probs (reference base.py:177-183),
        or None when there are none."""
        if self._entropy_cache is None and self._v_log_probs:
            total = None
            for lp in self._v_log_probs.values():
                total = lp if total is None else total + lp
            self._entropy_cache = -total
        return self._entropy_cache

    def _objective(self):
        raise NotImplementedError()

    @property
    def tensor(self):
        """The cached objective value."""
        if self._tensor_cache is None:
            self._tensor_cache = self._objective()
        return self._tensor_cache

    def __repr__(self):
        return "<{}>".format(type(self).__name__)
