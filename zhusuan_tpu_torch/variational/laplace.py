"""Laplace approximation: MAP + curvature -> Gaussian posterior and
evidence (port of ``zhusuan_tpu/variational/laplace.py``).

Find the posterior mode with L-BFGS, take the negative-log-density Hessian
there, and read off

    q(z) = N(z_MAP, H^{-1}),
    log Z ~= log p(z_MAP, x) + (D/2) log 2pi - (1/2) log det H.

Constrained latents go through
:func:`zhusuan_tpu_torch.bijectors.transform_log_joint` first.

The optimisation is a Python loop of exactly ``n_iters`` steps over the
FLATTENED latent (sorted-name order, ``jax.flatten_util.ravel_pytree``'s),
by default of :func:`._lbfgs.lbfgs`, the port's copy of ``optax.lbfgs()``,
whose iterates are optax's; the Hessian is one ``torch.func.hessian`` call
(forward-over-reverse, D^2 work: meant for the small and medium latents
where Laplace makes sense). Everything runs on the device of ``init``'s
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.variational._lbfgs import (
    LinesearchOptimizer,
    lbfgs,
    value_and_grad,
    value_and_grad_from_state,
)

__all__ = ["LaplaceResult", "laplace_approximation"]


class LaplaceResult(NamedTuple):
    """Output of :func:`laplace_approximation`."""

    mode: Dict  # {name: tensor}: the MAP point (same structure as init)
    log_evidence: torch.Tensor  # scalar Laplace log-evidence estimate
    chol_precision: torch.Tensor  # [D, D] lower Cholesky of the Hessian H
    grad_norm: torch.Tensor  # ||grad|| at the returned mode (convergence)
    log_post_mode: torch.Tensor  # log joint at the mode
    pd_hessian: torch.Tensor  # bool: the Hessian was positive definite at
    #   the returned point. False -> the optimizer stopped at a saddle,
    #   flat or non-log-concave region, and log_evidence / chol_precision
    #   are NaN: check this (or grad_norm) before trusting the result.


def ravel(tree: Dict[str, torch.Tensor]):
    """``(flat, unflatten)`` of a dict of tensors, leaves in sorted-name
    order (``jax.flatten_util.ravel_pytree``'s layout); ``unflatten`` takes
    a ``[D]`` tensor or a ``[n, D]`` batch (then every leaf gains the
    leading ``n``)."""
    names = sorted(tree)
    shapes = [tuple(tree[k].shape) for k in names]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([tree[k].reshape(-1) for k in names]) if names else \
        torch.zeros(0)

    def unflatten(x):
        lead = tuple(x.shape[:-1])
        out, off = {}, 0
        for k, shape, size in zip(names, shapes, sizes):
            out[k] = x[..., off:off + size].reshape(lead + shape)
            off += size
        return out

    return flat, unflatten


def laplace_approximation(
    meta_bn,
    observed: Dict,
    init: Dict,
    n_iters: int = 500,
    optimizer=None,
) -> LaplaceResult:
    """Fit the Laplace approximation around the posterior mode.

    :param meta_bn: model (``MetaBayesianNet`` or ``log_joint(obs_dict)``
        callable). For constrained latents, wrap with
        :func:`~zhusuan_tpu_torch.bijectors.transform_log_joint` first and
        pass the unconstrained init.
    :param observed: observation dict.
    :param init: dict of UNBATCHED initial latent values (no chain axes:
        this is a single optimization, not a sampler).
    :param n_iters: optimization steps (all of them run; no early stop).
    :param optimizer: default :func:`._lbfgs.lbfgs` (``optax.lbfgs()``):
        a :class:`._lbfgs.LinesearchOptimizer` is handed the objective and
        the value and gradient its line search stored. Any other update
        rule in the port's optax shape (``svgd.Optimizer``, e.g.
        :func:`~zhusuan_tpu_torch.variational.svgd.adagrad`) gets the flat
        latent as ``{"x": x}``: ``init({"x": x})``, ``update({"x": grad},
        state) -> ({"x": updates}, state)``. (The JAX package tells the two
        apart by a ``value`` in the optimizer's state.)
    :return: :class:`LaplaceResult`.
    """
    log_posterior = make_log_joint_fn(meta_bn, observed)
    init = {k: torch.as_tensor(v) for k, v in init.items()}
    x0, unflatten = ravel(init)
    with torch.no_grad():
        probe = tuple(log_posterior(init).shape)
    if probe != ():
        raise ValueError(
            "laplace_approximation needs an UNBATCHED latent (scalar "
            "log-joint); got log-joint shape {}. Drop the chain axes "
            "from init.".format(probe))

    def neg(x):
        return -log_posterior(unflatten(x))

    if optimizer is None:
        optimizer = lbfgs()
    x = x0.detach()
    if isinstance(optimizer, LinesearchOptimizer):
        from_state = value_and_grad_from_state(neg)
        state = optimizer.init(x)
        for _ in range(int(n_iters)):
            value, grad = from_state(x, state=state)
            updates, state = optimizer.update(grad, state, x, value=value,
                                              grad=grad, value_fn=neg)
            x = x + updates
    else:
        state = optimizer.init({"x": x})
        for _ in range(int(n_iters)):
            updates, state = optimizer.update(
                {"x": value_and_grad(neg, x)[1]}, state)
            x = x + updates["x"]

    grad_norm = torch.linalg.norm(value_and_grad(neg, x)[1])
    hess = torch.func.hessian(neg)(x)
    chol, info = torch.linalg.cholesky_ex(hess)
    # An indefinite Hessian (saddle, flat or non-log-concave point) gives
    # jnp.linalg.cholesky's NaN lower triangle, and an explicit flag.
    chol = torch.where(info == 0, chol,
                       torch.full_like(chol, math.nan).tril())
    pd = torch.all(torch.isfinite(chol))
    d = x.shape[0]
    half_log_det = torch.sum(torch.log(torch.diagonal(chol)))
    with torch.no_grad():
        lp_mode = -neg(x)
    log_z = torch.where(
        pd, lp_mode + 0.5 * d * math.log(2.0 * math.pi) - half_log_det,
        torch.full_like(lp_mode, math.nan))
    return LaplaceResult(
        mode=unflatten(x),
        log_evidence=log_z,
        chol_precision=chol,
        grad_norm=grad_norm,
        log_post_mode=lp_mode,
        pd_hessian=pd,
    )

