"""Bijectors: run unconstrained samplers over constrained latents.

Port of ``zhusuan_tpu/bijectors.py`` (plain tensor math: no kernel). Beyond
the reference: upstream ZhuSuan's HMC assumes unconstrained
latents (its examples hand-reparameterize, e.g. sampling ``logstd``
instead of ``std``). These helpers make that mechanical and
Jacobian-correct: declare each constrained latent's support once and
sample the unconstrained coordinates with ANY kernel (HMC, ChEES, MALA,
SMC rejuvenation, ...):

    ulj, to_u, to_c = transform_log_joint(log_joint, {"sigma": Softplus()})
    state = hmc.init(to_u({"sigma": sigma0, "w": w0}), n_chain_dims=1)
    state, out = hmc.run(ulj, {}, state, key, n_iters)
    sigma_draws = to_c(out["samples"])["sigma"]

Same interface family as :func:`zhusuan_tpu_torch.mcmc.whiten_log_joint`
(precondition.py): a transformed density plus coordinate maps. The
change-of-variables term ``log|d forward/dy|`` is summed over each
latent's DATA axes (everything beyond the chain axes, inferred from the
log-joint's output rank), so arbitrary chain/batch layouts work unchanged.

Scalar maps (Exp/Softplus/Sigmoid) are elementwise; the vector maps
(StickBreaking for simplexes, Ordered for cutpoints, CorrelationCholesky
for LKJ factors) consume trailing event axes and return their log-det
event-reduced, so the same summation logic covers both.

``softplus`` is ``logaddexp(y, 0)`` as in the JAX package, not
``torch.nn.functional.softplus``, whose linear branch above 20 is off by
``exp(-y)``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "Bijector",
    "Exp",
    "Softplus",
    "Sigmoid",
    "StickBreaking",
    "Ordered",
    "CorrelationCholesky",
    "transform_log_joint",
]


class Bijector:
    """Map ``forward: unconstrained -> constrained``.

    Elementwise by default. VECTOR bijectors (simplex, ordered,
    correlation-Cholesky) consume trailing event axes and may change the
    trailing shape; they return ``forward_log_det`` with the event axes
    ALREADY reduced (so downstream sums over remaining batch axes work
    unchanged) and declare the unconstrained trailing shape via
    :meth:`unconstrained_shape`.
    """

    def forward(self, y):
        raise NotImplementedError()

    def inverse(self, x):
        raise NotImplementedError()

    def forward_log_det(self, y):
        """``log|d forward(y) / dy|`` — elementwise for scalar
        bijectors; event-axes-reduced for vector bijectors."""
        raise NotImplementedError()

    def unconstrained_shape(self, constrained_shape):
        """Trailing shape of the unconstrained coordinates for a given
        constrained sample shape (identity for elementwise maps)."""
        return tuple(constrained_shape)


class Exp(Bijector):
    """``x = exp(y)``: positive supports (scales, rates)."""

    def forward(self, y):
        return torch.exp(y)

    def inverse(self, x):
        return torch.log(x)

    def forward_log_det(self, y):
        return y


class Softplus(Bijector):
    """``x = softplus(y)``: positive supports with linear tails (less
    overflow-prone than Exp for heavy-tailed posteriors)."""

    def forward(self, y):
        return torch.logaddexp(y, torch.zeros_like(y))

    def inverse(self, x):
        # softplus^{-1}(x) = x + log(1 - exp(-x)), stable for large x.
        return x + torch.log(-torch.expm1(-x))

    def forward_log_det(self, y):
        return F.logsigmoid(y)


class Sigmoid(Bijector):
    """``x = lo + (hi - lo) * sigmoid(y)``: interval supports."""

    def __init__(self, lo=0.0, hi=1.0):
        if not float(hi) > float(lo):
            raise ValueError("Sigmoid bijector needs hi > lo.")
        self._lo = float(lo)
        self._hi = float(hi)

    def forward(self, y):
        return self._lo + (self._hi - self._lo) * torch.sigmoid(y)

    def inverse(self, x):
        u = (x - self._lo) / (self._hi - self._lo)
        return torch.log(u) - torch.log1p(-u)

    def forward_log_det(self, y):
        return (math.log(self._hi - self._lo) + F.logsigmoid(y)
                + F.logsigmoid(-y))


def _cumsum_exclusive(x, axis=-1):
    incl = torch.cumsum(x, dim=axis)
    return incl - x


class StickBreaking(Bijector):
    """``y [..., K-1] -> simplex x [..., K]`` (Stan's stick-breaking
    construction, ref. Stan manual 10.7): ``z_k = sigmoid(y_k -
    log(K-1-k))`` eats fraction ``z_k`` of the remaining stick; the last
    coordinate is the leftover. The log-shift makes ``y = 0`` map to the
    uniform simplex. Vector bijector: event axis reduced in the log-det,
    trailing shape shrinks by one in the unconstrained space."""

    def _logits(self, y):
        km1 = y.shape[-1]
        offset = torch.log(torch.arange(km1, 0, -1, dtype=y.dtype,
                                        device=y.device))
        return y - offset

    def forward(self, y):
        t = self._logits(y)
        log_z = F.logsigmoid(t)
        log_1mz = F.logsigmoid(-t)
        csum = _cumsum_exclusive(log_1mz)
        log_head = log_z + csum  # log x_k, k < K-1
        log_last = torch.sum(log_1mz, dim=-1, keepdim=True)
        return torch.exp(torch.cat([log_head, log_last], dim=-1))

    def inverse(self, x):
        km1 = x.shape[-1] - 1
        head = x[..., :km1]
        remainder = 1.0 - _cumsum_exclusive(x)[..., :km1]
        z = head / remainder
        offset = torch.log(torch.arange(km1, 0, -1, dtype=x.dtype,
                                        device=x.device))
        return torch.log(z) - torch.log1p(-z) + offset

    def forward_log_det(self, y):
        t = self._logits(y)
        log_z = F.logsigmoid(t)
        log_1mz = F.logsigmoid(-t)
        csum = _cumsum_exclusive(log_1mz)
        # dx_k/dz_k = remainder_k; dz_k/dy_k = z_k (1 - z_k).
        return torch.sum(log_z + log_1mz + csum, dim=-1)

    def unconstrained_shape(self, constrained_shape):
        s = tuple(constrained_shape)
        if not s or s[-1] < 2:
            raise ValueError(
                "StickBreaking needs a trailing simplex axis of >= 2; "
                "got shape {}.".format(s)
            )
        return s[:-1] + (s[-1] - 1,)


class Ordered(Bijector):
    """``y [..., K] -> strictly increasing x [..., K]``: ``x_0 = y_0``,
    ``x_k = x_{k-1} + exp(y_k)`` (cutpoints, ordered mixture locations).
    Vector bijector (same trailing shape)."""

    def forward(self, y):
        x0 = y[..., :1]
        rest = x0 + torch.cumsum(torch.exp(y[..., 1:]), dim=-1)
        return torch.cat([x0, rest], dim=-1)

    def inverse(self, x):
        return torch.cat(
            [x[..., :1], torch.log(torch.diff(x, dim=-1))], dim=-1
        )

    def forward_log_det(self, y):
        return torch.sum(y[..., 1:], dim=-1)


class CorrelationCholesky(Bijector):
    """``y [..., K(K-1)/2] -> lower Cholesky factor L [..., K, K]`` of a
    correlation matrix (unit-norm rows), via canonical partial
    correlations ``z = tanh(y)`` filled into the strict lower triangle
    row-major (Stan's ``cholesky_corr_constrain``). The natural
    unconstrained coordinates for ``LKJCholesky`` latents under
    HMC/ADVI. Vector bijector: input event rank 1, output event rank 2.
    """

    @staticmethod
    def _k_from_flat(m):
        k = int((1 + np.sqrt(1 + 8 * m)) // 2)
        if k * (k - 1) // 2 != m:
            raise ValueError(
                "Trailing size {} is not K(K-1)/2 for integer K.".format(m)
            )
        return k

    @staticmethod
    def _partial_correlations(y, k):
        """``tanh(y)`` filled row-major into the strict lower triangle of a
        ``[..., k, k]`` matrix of zeros."""
        rows, cols = np.tril_indices(k, -1)
        zmat = torch.zeros(y.shape[:-1] + (k, k), dtype=y.dtype,
                           device=y.device)
        zmat[..., rows, cols] = torch.tanh(y)
        return zmat, rows, cols

    def forward(self, y):
        k = self._k_from_flat(y.shape[-1])
        zmat, _, _ = self._partial_correlations(y, k)
        log_1mz2 = torch.log1p(-torch.square(zmat))  # 0 off the triangle
        pref = _cumsum_exclusive(log_1mz2)  # sum over k < j within row
        strict = torch.tril(torch.ones((k, k), dtype=y.dtype,
                                       device=y.device), -1)
        lower = zmat * torch.exp(0.5 * pref) * strict
        diag = torch.exp(0.5 * torch.diagonal(pref, dim1=-2, dim2=-1))
        return lower + torch.diag_embed(diag)

    def inverse(self, x):
        k = x.shape[-1]
        rows, cols = np.tril_indices(k, -1)
        cumsq = _cumsum_exclusive(torch.square(x))
        z = x / torch.sqrt(torch.clamp(1.0 - cumsq, min=1e-30))
        zt = z[..., rows, cols]
        return torch.atanh(torch.clamp(zt, -1.0 + 1e-15, 1.0 - 1e-15))

    def forward_log_det(self, y):
        k = self._k_from_flat(y.shape[-1])
        zmat, rows, cols = self._partial_correlations(y, k)
        log_1mz2 = torch.log1p(-torch.square(zmat))
        pref = _cumsum_exclusive(log_1mz2)
        # tanh' = 1 - z^2 per coordinate, plus the stick prefactor
        # sqrt(1 - sum_{k<j} L^2) = exp(pref/2) per strict-lower entry.
        per = (log_1mz2 + 0.5 * pref)[..., rows, cols]
        return torch.sum(per, dim=-1)

    def unconstrained_shape(self, constrained_shape):
        s = tuple(constrained_shape)
        if len(s) < 2 or s[-1] != s[-2] or s[-1] < 2:
            raise ValueError(
                "CorrelationCholesky needs a trailing [K, K] (K >= 2) "
                "shape; got {}.".format(s)
            )
        k = s[-1]
        return s[:-2] + (k * (k - 1) // 2,)


def transform_log_joint(log_joint, bijectors: Dict[str, Bijector]):
    """Build the unconstrained density and the coordinate maps.

    :param log_joint: ``log_joint(obs_dict)`` callable or a
        :class:`~zhusuan_tpu_torch.framework.meta_bn.MetaBayesianNet`.
    :param bijectors: ``{latent_name: Bijector}`` for every constrained
        latent; unnamed latents pass through untouched.
    :return: ``(unconstrained_log_joint, to_unconstrained,
        to_constrained)`` — the density over the unconstrained
        coordinates (change-of-variables term included) plus dict maps
        in both directions.
    """
    from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn

    log_joint = make_log_joint_fn(log_joint, {})
    bijectors = dict(bijectors)

    def to_constrained(latent):
        return {
            k: (bijectors[k].forward(v) if k in bijectors else v)
            for k, v in latent.items()
        }

    def to_unconstrained(latent):
        return {
            k: (bijectors[k].inverse(torch.as_tensor(v)) if k in bijectors
                else v)
            for k, v in latent.items()
        }

    def unconstrained_log_joint(obs):
        lp = log_joint(to_constrained(dict(obs)))
        for name, bij in bijectors.items():
            ldj = bij.forward_log_det(obs[name])
            # Sum over data axes: everything beyond the chain rank, which
            # is the log-joint output's rank.
            axes = tuple(range(lp.ndim, ldj.ndim))
            lp = lp + (torch.sum(ldj, dim=axes) if axes else ldj)
        return lp

    return unconstrained_log_joint, to_unconstrained, to_constrained
