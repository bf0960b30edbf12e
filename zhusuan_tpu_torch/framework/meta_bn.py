"""MetaBayesianNet: the reusable model lambda.

Port of ``zhusuan_tpu/framework/meta_bn.py`` (parity: reference
``zhusuan/framework/meta_bn.py``): ``MetaBayesianNet`` wrapping a builder
with its arguments (meta_bn.py:29-106) and the ``meta_bayesian_net``
decorator (meta_bn.py:109-148). ``observe(key, **observations)`` runs the
builder inside a ``Local`` carrying the observations and the int seed
``key``.
"""

from __future__ import annotations

import functools
from typing import Callable

from zhusuan_tpu_torch.framework.bn import BayesianNet
from zhusuan_tpu_torch.framework.utils import Local

__all__ = ["MetaBayesianNet", "meta_bayesian_net"]


class MetaBayesianNet:
    """A model "lambda": a builder function plus captured arguments that can
    be instantiated into :class:`BayesianNet` s under different
    observations.

    :param f: the builder; must return a :class:`BayesianNet`.
    :param args/kwargs: captured builder arguments.

    ``log_joint`` may be set to a callable ``bn -> log_joint`` to override
    the default sum of conditional log-probabilities (reference
    meta_bn.py:69-85), e.g. to rescale a minibatch likelihood.
    """

    def __init__(self, f: Callable, args=(), kwargs=None, scope=None):
        self._f = f
        self._args = tuple(args)
        self._kwargs = dict(kwargs or {})
        self._scope = scope  # kept for API parity; unused
        self._log_joint = None

    @property
    def log_joint(self):
        """Optional user-defined log-joint callable taking the instantiated
        :class:`BayesianNet` (reference meta_bn.py:69-85)."""
        return self._log_joint

    @log_joint.setter
    def log_joint(self, value):
        self._log_joint = value

    def _run_with_local(self, local: Local) -> BayesianNet:
        with local:
            bn = self._f(*self._args, **self._kwargs)
        if not isinstance(bn, BayesianNet):
            raise TypeError(
                "The model builder function should return a BayesianNet "
                "instance, got {!r}.".format(type(bn)))
        return bn

    def observe(self, key=None, **observations) -> BayesianNet:
        """Instantiate the model with the given observations (reference
        ``meta_bn.py:93-106``).

        :param key: int seed of the unobserved nodes' generators, or None
            for a fully observed net.
        :param observations: named observations, each broadcastable to the
            corresponding node's ``batch_shape + value_shape``.
        """
        return self._run_with_local(
            Local(observations=observations, meta_bn=self, key=key))

    def observe_with_noise(self, noise, key=None, **observations):
        """:meth:`observe` with ``noise={name: eps}`` handed to the nets the
        model function makes (``BayesianNet(noise=...)``'s testing hook: a
        node's base draws replaced, so that two packages can be fed the
        same numbers)."""
        return self._run_with_local(
            Local(observations=observations, meta_bn=self, key=key,
                  noise=noise))

    def __repr__(self):
        return "<MetaBayesianNet f={}>".format(
            getattr(self._f, "__name__", self._f))


def meta_bayesian_net(scope=None, reuse_variables=None):
    """Decorator turning a builder function into a :class:`MetaBayesianNet`
    factory (reference ``meta_bn.py:109-148``). ``scope`` and
    ``reuse_variables`` are accepted for source compatibility and do
    nothing: parameters are explicit.

    Usage::

        @meta_bayesian_net()
        def build_model(params, n_particles):
            bn = BayesianNet()
            ...
            return bn

        model = build_model(params, 32)       # -> MetaBayesianNet
        bn = model.observe(seed, x=x_batch)   # -> BayesianNet
    """
    if callable(scope):  # bare-decorator use: @meta_bayesian_net
        return meta_bayesian_net()(scope)

    def deco(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            return MetaBayesianNet(f, args=args, kwargs=kwargs, scope=scope)

        return wrapped

    return deco
