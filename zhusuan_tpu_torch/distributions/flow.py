"""FlowDistribution: a normalizing flow pushed forward from a base
distribution, as a :class:`Distribution` (port of
``zhusuan_tpu/distributions/flow.py``).

For ``x = f(z)``, ``z ~ base``, the change of variables gives

    log p(x) = base.log_prob(f^{-1}(x)) + log|det J_{f^{-1}}(x)|.

``sample`` pushes base draws through ``forward``; ``log_prob`` needs the
exact ``inverse`` (affine couplings have one:
:func:`zhusuan_tpu_torch.transform.coupling_flow_pair`). A forward-only
flow (planar, IAF) may be wrapped for sampling; scoring then raises.

``sample`` takes the base's ``eps=`` (its base draws, e.g. the standard
normals of a ``Normal`` base), so ``bn.stochastic("z", FlowDistribution.
coupling(...), n_samples=...)`` takes ``noise={"z": eps}``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from zhusuan_tpu_torch.distributions.base import Distribution

__all__ = ["FlowDistribution"]

# flow callables map (samples [..., d], log_probs [...]) -> same-shaped pair.
FlowFn = Callable


class FlowDistribution(Distribution):
    """Distribution of ``x = forward(z)`` with ``z ~ base``.

    :param base: a continuous :class:`Distribution` whose ``log_prob``
        reduces exactly the last sample axis, e.g. ``Normal(zeros(d),
        std=1., group_ndims=1)`` or ``MultivariateNormalCholesky``; the
        flow acts on that axis.
    :param forward: ``(z [..., d], log_p [...]) -> (x, log_p - log|det
        J_f|)``, the convention of every flow in
        :mod:`zhusuan_tpu_torch.transform`.
    :param inverse: the exact inverse with the same convention,
        ``(x, log_p) -> (z, log_p + log|det J_f^{-1}|)``, i.e.
        ``affine_coupling_flow(..., inverse=True)``; None makes the
        distribution sample-only.
    :param group_ndims: trailing batch axes summed into one event (beyond
        the flow's own last axis).
    """

    def __init__(self, base: Distribution, forward: FlowFn,
                 inverse: Optional[FlowFn] = None, group_ndims: int = 0):
        if not isinstance(base, Distribution):
            raise TypeError(
                "base should be a Distribution, got {!r}.".format(type(base)))
        if not base.is_continuous:
            raise ValueError(
                "FlowDistribution requires a continuous base distribution "
                "(change of variables needs a density).")
        full = tuple(base.batch_shape) + tuple(base.value_shape)
        if len(full) < 1 or full[-1] < 1:
            raise ValueError(
                "The base distribution must have at least one sample axis "
                "for the flow to act on; got batch_shape={} value_shape={}."
                .format(base.batch_shape, base.value_shape))
        # base.log_prob must reduce exactly the last axis (so the flows'
        # log-dets, summed over it, add up). Probed on one event with
        # every batch axis of size 1 (it broadcasts against the base's
        # parameters), never on a full sample.
        probe = torch.zeros((1,) * (len(full) - 1) + full[-1:],
                            dtype=base.dtype, device=base.device)
        with torch.no_grad():
            out_shape = tuple(base.log_prob(probe).shape)
        if out_shape != full[:-1]:
            raise ValueError(
                "base.log_prob must reduce exactly the last sample axis: "
                "for samples of shape {} it returned shape {} (expected {})."
                " Use e.g. Normal(..., group_ndims=1) or a multivariate "
                "base.".format(full, out_shape, full[:-1]))
        super().__init__(
            dtype=base.dtype,
            param_dtype=base.param_dtype,
            is_continuous=True,
            is_reparameterized=base.is_reparameterized,
            group_ndims=group_ndims,
            device=base.device,
        )
        self._base = base
        self._forward = forward
        self._inverse = inverse
        self._full_shape = full

    @classmethod
    def coupling(cls, base, params, **kwargs):
        """Affine-coupling (RealNVP) flow over ``base``, the invertible
        default; ``params`` from
        :func:`zhusuan_tpu_torch.transform.init_affine_coupling`."""
        from zhusuan_tpu_torch.transform import coupling_flow_pair

        fwd, inv = coupling_flow_pair(params)
        return cls(base, fwd, inv, **kwargs)

    @property
    def base(self) -> Distribution:
        """The base (pre-flow) distribution."""
        return self._base

    def _batch_shape(self):
        return self._full_shape[:-1]

    def _value_shape(self):
        return self._full_shape[-1:]

    def _sample(self, generator, n_samples: int, eps):
        z = self._base.sample(generator, n_samples, eps=eps)
        zeros = torch.zeros(z.shape[:-1], dtype=self.param_dtype,
                            device=z.device)
        x, _ = self._forward(z, zeros)
        return x

    def _log_prob(self, given):
        if self._inverse is None:
            raise NotImplementedError(
                "This FlowDistribution was built without an inverse, so it "
                "is sample-only. Provide inverse= (affine couplings have an "
                "exact one) or score via the latent={name: (samples, "
                "log_probs)} objective path.")
        # Rank-1 input is one d-vector only when there are no batch axes;
        # with a batched base it broadcasts against batch_shape (the flows
        # take rank >= 2, so lift it).
        squeeze = given.ndim == 1 and len(self._full_shape) == 1
        if given.ndim == 1 and not squeeze:
            given = given.expand(self._full_shape[:-1] + tuple(given.shape))
        g = given[None] if squeeze else given
        zeros = torch.zeros(g.shape[:-1], dtype=self.param_dtype,
                            device=g.device)
        z0, delta = self._inverse(g, zeros)
        lp = self._base.log_prob(z0) + delta
        return lp[0] if squeeze else lp
