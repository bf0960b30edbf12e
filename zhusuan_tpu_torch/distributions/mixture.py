"""Finite mixture distribution (MixtureSameFamily semantics).

Port of ``zhusuan_tpu/distributions/mixture.py``: one batched component
distribution whose last batch axis (length K) indexes the components, and
mixture weights ``softmax(logits)``. ``log_prob`` marginalizes the
assignment, ``logsumexp(log_softmax(logits) + comp.log_prob(x), -1)``, so
gradients reach the weights and the components' parameters with no
REINFORCE machinery.
"""

from __future__ import annotations

import numpy as np
import torch

from zhusuan_tpu_torch.distributions.base import Distribution

__all__ = ["Mixture"]


class Mixture(Distribution):
    """Mixture of a batched component distribution (JAX
    ``mixture.py:31-148``).

    ``components`` is a single :class:`Distribution` whose LAST batch axis
    (length K) indexes the mixture components, e.g. ``Normal(mean=[K],
    std=[K])`` for a K-component scalar GMM. ``logits`` broadcasts to
    ``components.batch_shape`` (last axis K). The mixture has
    ``batch_shape = broadcast(logits, components.batch_shape)[:-1]`` and the
    components' ``value_shape``.

    Sampler: every component drawn, then the assignment ``argmax(logits +
    Gumbel)`` (the Gumbels ``-log(-log u)`` of ``u`` uniform on (0, 1), of
    shape ``[n] + batch_shape + [K]``) picks one. ``eps=(comp_eps, u)``
    carries the components' base draws and ``u``; the JAX package draws
    them from ``split(key) -> key_comp, key_cat``. Not reparameterized.

    :param logits: unnormalized mixture log-weights, last axis K >= 1.
    :param components: component distribution with K as its last batch
        axis and ``group_ndims == 0``.
    """

    def __init__(self, logits, components, group_ndims: int = 0, **kwargs):
        if not isinstance(components, Distribution):
            raise TypeError(
                "components must be a Distribution; got {!r}."
                .format(type(components)))
        if components.group_ndims != 0:
            raise ValueError(
                "Mixture requires components with group_ndims=0 (the "
                "mixture marginalization needs per-component densities); "
                "apply group_ndims to the Mixture itself instead.")
        logits = torch.as_tensor(logits, device=components.device)
        if not logits.is_floating_point():
            raise TypeError("logits must be a float array.")
        if logits.ndim < 1:
            raise ValueError("logits must have at least one axis (K).")
        comp_batch = tuple(components.batch_shape)
        if len(comp_batch) < 1:
            raise ValueError(
                "components must have at least one batch axis (the "
                "component axis K); got batch_shape {}.".format(comp_batch))
        k = comp_batch[-1]
        if logits.shape[-1] != k:
            raise ValueError(
                "logits last axis ({}) must equal the component axis K "
                "({}).".format(logits.shape[-1], k))
        full = np.broadcast_shapes(tuple(logits.shape), comp_batch)
        self._logits = logits
        self._n_components = int(k)
        self._components = components
        self._full_batch_shape = tuple(full)
        self._mixture_batch_shape = tuple(full[:-1])
        super().__init__(
            dtype=components.dtype,
            param_dtype=logits.dtype,
            is_continuous=components.is_continuous,
            is_reparameterized=False,
            group_ndims=group_ndims,
            device=components.device,
            **kwargs,
        )

    logits = property(lambda self: self._logits,
                      doc="Unnormalized mixture log-weights.")
    components = property(lambda self: self._components,
                          doc="The K-batched component distribution.")
    n_components = property(lambda self: self._n_components,
                            doc="Number of mixture components K.")

    def _batch_shape(self):
        return self._mixture_batch_shape

    def _value_shape(self):
        return tuple(self._components.value_shape)

    @property
    def _value_ndims(self):
        return len(self._components.value_shape)

    def sample(self, generator=None, n_samples=None, *, eps=None):
        if n_samples is None and eps is not None:
            # One sample: the base class's leading axis on both parts.
            eps = tuple(None if e is None else torch.as_tensor(e)[None]
                        for e in eps)
            return self._sample(generator, 1, eps).squeeze(0)
        return super().sample(generator, n_samples, eps=eps)

    def _sample(self, generator, n_samples, eps):
        comp_eps, u = (None, None) if eps is None else eps
        if eps is None and generator is None:
            raise ValueError("Sampling needs a torch.Generator or eps.")
        # [n] + full_batch + value: all components, static shapes.
        comp = self._components.sample(generator, n_samples=n_samples,
                                       eps=comp_eps)
        comp = comp.expand((n_samples,) + self._full_batch_shape
                           + tuple(self.value_shape))
        u = self._open_uniforms(
            generator, (n_samples,) + self._mixture_batch_shape
            + (self._n_components,), u)
        idx = torch.argmax(self._logits.detach() - torch.log(-torch.log(u)),
                           dim=-1)
        k_axis = comp.ndim - self._value_ndims - 1
        idx_e = idx.reshape(tuple(idx.shape) + (1,) * (self._value_ndims + 1))
        idx_e = idx_e.expand(tuple(idx.shape) + (1,)
                             + tuple(comp.shape[k_axis + 1:]))
        return torch.gather(comp, k_axis, idx_e).squeeze(k_axis)

    def _log_prob(self, given):
        # The K axis goes just before the value axes, so `given` broadcasts
        # against the K-batched component parameters.
        g = given.unsqueeze(-(self._value_ndims + 1))
        comp_lp = self._components.log_prob(g)
        log_w = torch.log_softmax(self._logits, dim=-1)
        return torch.logsumexp(log_w + comp_lp, dim=-1)
