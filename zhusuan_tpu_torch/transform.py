"""Normalizing flows: planar flows, inverse autoregressive flows and affine
couplings (port of ``zhusuan_tpu/transform.py``).

Parity: reference ``zhusuan/transform.py``: ``planar_normalizing_flow``
(transform.py:70-198) with the invertibility reparameterization of Rezende
& Mohamed (2015), ``inv_autoregressive_flow`` (transform.py:201-291) with
pluggable autoregressive nets and the masked ``linear_ar``
(transform.py:17-67); and the JAX package's affine couplings (RealNVP),
forward and exact inverse, with ``coupling_flow_pair``.

Flow parameters are explicit lists of ``{name: tensor}`` dicts made by the
``init_*`` helpers from a ``torch.Generator`` (the JAX package's take a
PRNG key); :func:`params_from_numpy` / :func:`params_to_numpy` carry them
across from and to the JAX package's arrays. The flow arithmetic follows
the JAX functions operation for operation.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

__all__ = [
    "planar_normalizing_flow",
    "init_planar_flow",
    "inv_autoregressive_flow",
    "linear_ar",
    "init_linear_ar",
    "affine_coupling_flow",
    "init_affine_coupling",
    "coupling_flow_pair",
    "params_from_numpy",
    "params_to_numpy",
]


def _randn(generator, shape, dtype):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


def _check_ranks(samples, log_probs):
    if samples.ndim < 2:
        raise ValueError("samples should have rank >= 2")
    if log_probs.ndim != samples.ndim - 1:
        raise ValueError(
            "log_probs should have rank (N-1), while N is the rank of samples"
        )


def _as_pair(samples, log_probs):
    samples = torch.as_tensor(samples)
    log_probs = torch.as_tensor(log_probs, dtype=samples.dtype,
                                device=samples.device)
    _check_ranks(samples, log_probs)
    return samples, log_probs


def init_planar_flow(generator, n_iters: int, d: int, dtype=torch.float32):
    """Parameters of ``n_iters`` stacked planar flows over a last axis of
    ``d`` (reference transform.py:152-165): ``b = 0``, ``u`` and ``w``
    from ``Normal(0, 0.005)``, drawn from ``generator`` on its device.

    :return: list of ``{"u": [d], "w": [d], "b": []}`` dicts.
    """
    params = []
    for _ in range(int(n_iters)):
        u = 0.005 * _randn(generator, (d,), dtype)
        w = 0.005 * _randn(generator, (d,), dtype)
        params.append({"u": u, "w": w,
                       "b": torch.zeros((), dtype=dtype,
                                        device=generator.device)})
    return params


def _planar_u_hat(u, w):
    """Invertibility reparameterization
    ``u_hat = u + w*(softplus(w.u) - 1 - w.u)/||w||^2``
    (reference transform.py:161-165), so that ``w.u_hat >= -1``."""
    wu = torch.sum(w * u, dim=-1)
    softplus = torch.logaddexp(wu, torch.zeros_like(wu))  # jax.nn.softplus
    return u + w * (softplus - 1.0 - wu) / torch.sum(w * w, dim=-1)


def planar_normalizing_flow(samples, log_probs, params):
    """Stacked planar flows ``z <- z + u_hat * tanh(z.w + b)`` along the
    last axis, each subtracting ``log|1 + (u_hat.w) (1 - tanh^2(z.w +
    b))|`` from ``log_probs`` (reference transform.py:168-196).

    :param samples: ``[..., d]``; :param log_probs: ``[...]``.
    :param params: list from :func:`init_planar_flow`.
    :return: ``(transformed_samples, transformed_log_probs)``.
    """
    z, log_probs = _as_pair(samples, log_probs)
    for p in params:
        u_hat = _planar_u_hat(p["u"], p["w"])
        scalar = torch.sum(u_hat * p["w"])
        activation = torch.tanh(
            torch.sum(z * p["w"], dim=-1, keepdim=True) + p["b"])
        act = activation.squeeze(-1)
        det_ja = scalar * (1.0 - act * act) + 1.0
        log_probs = log_probs - torch.log(det_ja)
        z = z + activation * u_hat
    return z, log_probs


def init_linear_ar(generator, n_iters: int, d: int, dtype=torch.float32):
    """Masked-linear autoregressive parameters (reference
    transform.py:50-58: ``Normal(0, 0.005)`` weights).

    :return: list of ``{"m_w": [d, d], "s_w": [d, d]}`` dicts.
    """
    return [{"m_w": 0.005 * _randn(generator, (d, d), dtype),
             "s_w": 0.005 * _randn(generator, (d, d), dtype)}
            for _ in range(int(n_iters))]


def linear_ar(params_i, z, hidden=None):
    """Masked linear autoregressive net returning ``(m, s)`` with
    ``s = exp(z @ (mask * s_w))``: output j depends only on inputs i < j
    (strictly upper-triangular mask; reference transform.py:17-67)."""
    d = z.shape[-1]
    mask = torch.triu(torch.ones((d, d), dtype=z.dtype, device=z.device),
                      diagonal=1)
    m = z @ (mask * params_i["m_w"])
    s = torch.exp(z @ (mask * params_i["s_w"]))
    return m, s


def inv_autoregressive_flow(samples, hidden, log_probs,
                            autoregressive_nn: Callable, params: List,
                            update: str = "normal"):
    """Inverse autoregressive flow (Kingma et al. 2016) along the last axis;
    the dimension order is reversed after each flow (reference
    transform.py:201-291).

    :param autoregressive_nn: ``(params_i, z, hidden) -> (m, s)``, e.g.
        :func:`linear_ar`.
    :param params: list of per-flow parameters.
    :param update: ``"normal"`` (``z = s*z + m``) or ``"gru"``
        (``z = sigmoid(s)*z + (1-sigmoid(s))*m``).
    :return: ``(transformed_samples, transformed_log_probs)``.
    """
    z, joint_probs = _as_pair(samples, log_probs)
    if update not in ("normal", "gru"):
        raise ValueError("update should be 'normal' or 'gru'")
    for p in params:
        m, s = autoregressive_nn(p, z, hidden)
        if update == "gru":
            sigma = torch.sigmoid(s)
            z = sigma * z + (1.0 - sigma) * m
            joint_probs = joint_probs - torch.sum(torch.log(sigma), dim=-1)
        else:
            z = s * z + m
            joint_probs = joint_probs - torch.sum(torch.log(s), dim=-1)
        z = torch.flip(z, dims=(-1,))
    return z, joint_probs


# --------------------------------------------------------------------- #
# Affine coupling (RealNVP)
# --------------------------------------------------------------------- #
def init_affine_coupling(generator, n_iters: int, d: int, hidden: int = 64,
                         dtype=torch.float32):
    """Parameters of ``n_iters`` affine couplings (RealNVP; Dinh et al.
    2017) over a last axis of ``d``: each flow conditions one half on the
    other through a 2-layer MLP emitting ``(shift, log_scale)``, the halves
    alternating between flows; the last layer starts at zero, so every
    flow starts as the identity.

    :return: list of ``{"w1", "b1", "w2", "b2"}`` dicts.
    """
    params = []
    d1 = d // 2
    d2 = d - d1
    dev = generator.device
    for i in range(int(n_iters)):
        n_in, n_out = (d1, d2) if i % 2 == 0 else (d2, d1)
        scale = math.sqrt(2.0 / n_in)
        params.append({
            "w1": scale * _randn(generator, (n_in, hidden), dtype),
            "b1": torch.zeros((hidden,), dtype=dtype, device=dev),
            "w2": torch.zeros((hidden, 2 * n_out), dtype=dtype, device=dev),
            "b2": torch.zeros((2 * n_out,), dtype=dtype, device=dev),
        })
    return params


def _coupling_net(p, x):
    h = torch.relu(x @ p["w1"] + p["b1"])
    out = h @ p["w2"] + p["b2"]
    shift, log_scale = torch.chunk(out, 2, dim=-1)
    # tanh keeps the log-scale in (-2, 2): scales in ~[0.14, 7.4].
    return shift, 2.0 * torch.tanh(log_scale / 2.0)


def affine_coupling_flow(samples, log_probs, params, inverse: bool = False):
    """Stacked affine couplings along the last axis.

    Forward (``inverse=False``) maps base samples toward the target and
    subtracts the forward log-det from ``log_probs``, the convention of
    :func:`planar_normalizing_flow`. ``inverse=True`` applies the exact
    inverse and subtracts the sum of the log-scales it undoes: with
    ``z0, delta = affine_coupling_flow(x, zeros, params, inverse=True)``
    the flow density of ``x`` is ``base_log_prob(z0) + delta``.

    :param samples: ``[..., d]``; :param log_probs: ``[...]``.
    :param params: list from :func:`init_affine_coupling`.
    :return: ``(transformed_samples, transformed_log_probs)``.
    """
    z, log_probs = _as_pair(samples, log_probs)
    d1 = z.shape[-1] // 2
    seq = list(enumerate(params))
    if inverse:
        seq = seq[::-1]
    for i, p in seq:
        if i % 2 == 0:
            cond, active = z[..., :d1], z[..., d1:]
        else:
            cond, active = z[..., d1:], z[..., :d1]
        shift, log_scale = _coupling_net(p, cond)
        if inverse:
            active = (active - shift) * torch.exp(-log_scale)
        else:
            active = active * torch.exp(log_scale) + shift
        log_probs = log_probs - torch.sum(log_scale, dim=-1)
        if i % 2 == 0:
            z = torch.cat([cond, active], dim=-1)
        else:
            z = torch.cat([active, cond], dim=-1)
    return z, log_probs


def coupling_flow_pair(params):
    """``(forward, inverse)``, each ``(samples, log_probs) -> (samples,
    log_probs)``, over one shared ``params`` (so gradients through either
    reach the same tensors): the interface
    :class:`~zhusuan_tpu_torch.distributions.FlowDistribution` takes."""

    def forward(samples, log_probs):
        return affine_coupling_flow(samples, log_probs, params)

    def inverse(samples, log_probs):
        return affine_coupling_flow(samples, log_probs, params, inverse=True)

    return forward, inverse


# --------------------------------------------------------------------- #
# Carrying parameters across
# --------------------------------------------------------------------- #
def params_from_numpy(params, device=None, dtype=None, requires_grad=True):
    """Flow parameters (a list of ``{name: array}`` dicts, e.g. the JAX
    package's ``init_*`` output through ``np.asarray``) as tensors on
    ``device`` (the card when None) in ``dtype`` (the arrays' own when
    None), leaves that require grad unless ``requires_grad`` is False."""
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)
    return [{k: torch.tensor(np.array(v), dtype=dtype, device=device)
             .requires_grad_(requires_grad) for k, v in p.items()}
            for p in params]


def params_to_numpy(params):
    """The flow parameters with every tensor as a numpy array."""
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in params]
