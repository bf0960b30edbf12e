"""Stein variational gradient descent (Liu & Wang 2016; port of
``zhusuan_tpu/variational/svgd.py``).

A set of interacting particles moves along the kernelized Stein
discrepancy's steepest-descent direction

    phi(x_i) = (1/n) sum_j [ k(x_j, x_i) grad_{x_j} log p(x_j)
                             + grad_{x_j} k(x_j, x_i) ],

MAP ascent for one particle, a sample from ``p`` as ``n`` grows;
deterministic given the initial particles. Each update is two
``[n, n] @ [n, D]`` matmuls (the kernel-smoothed score and the repulsion)
after one autograd pass for the scores; ``run`` is a Python loop over
``update``.

The default optimizer is :func:`adagrad`, the port's copy of
``optax.adagrad`` (its accumulator starts at 0.1 and scales by
``rsqrt(acc + eps)``, 0 where the accumulator is 0), not
``torch.optim.Adagrad`` (which starts at 0 and divides by
``sqrt(acc) + eps``). The median bandwidth comes from
:func:`_median_bisect`, which stops at the pass JAX's ``while_loop`` stops
at and so returns its value, not ``torch.median``'s.

Same model interface as the samplers: a ``MetaBayesianNet`` or a
``log_joint(obs_dict)`` callable, latents ``{name: [n_particles, ...]}``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch

from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn

__all__ = ["SVGD", "SVGDState", "SVGDInfo", "adagrad", "AdagradState",
           "rbf_kernel_terms", "state_from_numpy", "state_to_numpy"]

Latent = Dict[str, torch.Tensor]

class SVGDState(NamedTuple):
    """Explicit SVGD state; ``t`` is a host int."""

    particles: Latent  # {name: [n_particles, ...]}
    opt_state: Any  # the optimizer's state over the particle dict
    t: int


class SVGDInfo(NamedTuple):
    """Per-iteration diagnostics."""

    particles: Latent
    bandwidth: torch.Tensor  # RBF bandwidth h used this step
    grad_norm: torch.Tensor  # mean ||phi_i||_2 over particles
    log_prob: torch.Tensor  # [n_particles] log joint at the pre-update
    #                         particles (a by-product of the score pass)


class Optimizer(NamedTuple):
    """An update rule on dicts of tensors, in optax's shape:
    ``init(params) -> state``, ``update(grads, state) -> (updates,
    state)``; the step adds ``updates`` to the parameters."""

    init: Callable
    update: Callable


class ScaleByRssState(NamedTuple):
    """The running sums of squared gradients (optax's state of
    ``scale_by_rss``)."""

    sum_of_squares: Latent


class EmptyState(NamedTuple):
    """A stateless transform's state (optax's ``EmptyState``)."""


class AdagradState(tuple):
    """:func:`adagrad`'s state, laid out as ``optax.adagrad``'s chain:
    ``(ScaleByRssState, EmptyState)``, so that a checkpoint of it has the
    JAX package's paths (:mod:`~zhusuan_tpu_torch.checkpoint`). The running
    sums read as ``.sum_of_squares``."""

    def __new__(cls, sum_of_squares: Latent):
        return tuple.__new__(cls, (ScaleByRssState(sum_of_squares),
                                   EmptyState()))

    @property
    def sum_of_squares(self) -> Latent:
        return self[0].sum_of_squares


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Optimizer:
    """``optax.adagrad`` (optax 0.2.6, ``scale_by_rss`` then
    ``scale_by_learning_rate``): ``acc += g^2``, ``update = -lr * g *
    (rsqrt(acc + eps) if acc > 0 else 0)``, the accumulator starting at
    ``initial_accumulator_value``."""

    def init(params):
        return AdagradState({k: torch.full_like(v, initial_accumulator_value)
                             for k, v in params.items()})

    def update(grads, state):
        acc = {k: torch.square(g) + state.sum_of_squares[k]
               for k, g in grads.items()}
        updates = {k: -learning_rate * (torch.where(
            acc[k] > 0, torch.rsqrt(acc[k] + eps), 0.0) * g)
            for k, g in grads.items()}
        return updates, AdagradState(acc)

    return Optimizer(init, update)


def _flatten_particles(q: Latent):
    """``{name: [n, ...]}`` -> ``([n, D] matrix, unflatten(mat) ->
    dict)``, names in sorted order."""
    names = sorted(q.keys())
    n = q[names[0]].shape[0]
    sizes = [q[k].numel() // n for k in names]
    mat = torch.cat([q[k].reshape(n, -1) for k in names], dim=1)

    def unflatten(m):
        out, off = {}, 0
        for k, s in zip(names, sizes):
            out[k] = m[:, off:off + s].reshape(q[k].shape)
            off += s
        return out

    return mat, unflatten


def _median_bisect(x, rel_tol: float = 1e-4, max_iters: int = 64):
    """Median of a non-negative tensor by bisection on the empirical CDF:
    halve the bracket ``[0, max(x)]`` toward the point where half the
    entries lie below, until ``hi - lo <= rel_tol * mid`` or ``max_iters``
    passes. The relative test keeps one huge outlier (a 1e12 distance
    beside a median of 1) to a few more passes. Each pass is one compare
    and mean over ``x`` and one host read of the stopping test; the result
    is JAX's, pass for pass. (Running all ``max_iters`` passes on the
    device with the bracket frozen once the test fails needs no host read,
    but at 4096 particles on an H100 (80GB HBM3, 700 W) it took 11.69 ms
    against this route's 3.053: ``chip_smoke.py`` phase 31, PERF.md.)
    """
    tiny = torch.tensor(torch.finfo(x.dtype).tiny, dtype=x.dtype,
                        device=x.device)
    lo = torch.zeros((), dtype=x.dtype, device=x.device)
    hi = torch.max(x)
    for _ in range(int(max_iters)):
        mid = 0.5 * (lo + hi)
        if not bool((hi - lo) > rel_tol * torch.maximum(mid, tiny)):
            break
        below = torch.mean((x <= mid).to(x.dtype)) < 0.5
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def rbf_kernel_terms(x, bandwidth):
    """RBF kernel matrix and its summed input gradient for SVGD.

    :param x: ``[n, D]`` flattened particles.
    :param bandwidth: ``"median"`` (``h = median(sqdist) / log(n + 1)``,
        the Liu & Wang heuristic) or a positive float.
    :return: ``(K [n, n], repulsion [n, D], h)`` with
        ``repulsion[i] = sum_j grad_{x_j} k(x_j, x_i)``.
    """
    n = x.shape[0]
    x2 = torch.sum(x * x, dim=1)
    sqdist = torch.maximum(x2[:, None] + x2[None, :] - 2.0 * (x @ x.T),
                           x.new_zeros(()))
    if isinstance(bandwidth, str):
        if bandwidth != "median":
            raise ValueError(
                "bandwidth should be 'median' or a positive float, got "
                "{!r}.".format(bandwidth))
        h = _median_bisect(sqdist) / math.log(float(n) + 1.0)
        h = torch.maximum(h, torch.tensor(1e-8, dtype=x.dtype,
                                          device=x.device))
    else:
        h = torch.tensor(float(bandwidth), dtype=x.dtype, device=x.device)
    k_mat = torch.exp(-sqdist / h)
    # sum_j grad_{x_j} k(x_j, x_i) = (2/h) (x_i * sum_j K_ij - (K x)_i)
    repulsion = (2.0 / h) * (x * torch.sum(k_mat, dim=1, keepdim=True)
                             - k_mat @ x)
    return k_mat, repulsion, h


class SVGD:
    """Stein variational gradient descent.

    :param optimizer: an :class:`Optimizer` (``init`` / ``update`` on
        dicts of tensors) applied to the negated Stein direction; default
        :func:`adagrad` at ``learning_rate``, the choice of Liu & Wang
        (2016).
    :param learning_rate: used by the default optimizer only.
    :param bandwidth: ``"median"`` (default) or a fixed positive float.
    """

    def __init__(self, optimizer=None, learning_rate: float = 0.1,
                 bandwidth: Union[str, float] = "median"):
        self._opt = adagrad(learning_rate) if optimizer is None \
            else optimizer
        if isinstance(bandwidth, str):
            if bandwidth != "median":
                raise ValueError(
                    "bandwidth should be 'median' or a positive float, got "
                    "{!r}.".format(bandwidth))
        elif not float(bandwidth) > 0.0:
            raise ValueError("bandwidth must be positive.")
        self._bandwidth = bandwidth

    def init(self, latent: Latent) -> SVGDState:
        """The initial state at ``{name: [n_particles, ...]}`` particles
        (e.g. prior draws)."""
        q = {k: torch.as_tensor(v) for k, v in latent.items()}
        n_set = {v.shape[0] if v.ndim else None for v in q.values()}
        if None in n_set or len(n_set) != 1:
            raise ValueError(
                "All latent arrays must share a leading n_particles axis; "
                "got shapes {}.".format(
                    {k: tuple(v.shape) for k, v in q.items()}))
        n = n_set.pop()
        if n < 2:
            raise ValueError(
                "SVGD needs at least 2 interacting particles, got {}; use "
                "MAP optimization directly for a single point estimate."
                .format(n))
        return SVGDState(particles=q, opt_state=self._opt.init(q), t=0)

    def _phi(self, log_posterior, q: Latent):
        """The Stein direction as a latent dict, and diagnostics."""
        names = sorted(q)
        leaves = {k: q[k].detach().requires_grad_(True) for k in names}
        with torch.enable_grad():
            lp = log_posterior(leaves)
            grads = torch.autograd.grad(torch.sum(lp),
                                        [leaves[k] for k in names],
                                        allow_unused=True)
        grads = {k: torch.zeros_like(q[k]) if g is None else g
                 for k, g in zip(names, grads)}
        x, unflatten = _flatten_particles(q)
        g, _ = _flatten_particles(grads)
        n = x.shape[0]
        k_mat, repulsion, h = rbf_kernel_terms(x, self._bandwidth)
        phi = (k_mat @ g + repulsion) / float(n)
        grad_norm = torch.mean(torch.sqrt(torch.sum(phi * phi, dim=1)))
        return unflatten(phi), h, grad_norm, lp.detach()

    def update(self, meta_bn, observed, state: SVGDState):
        """One SVGD step: ``(new_state, SVGDInfo)``."""
        log_posterior = make_log_joint_fn(meta_bn, observed)
        with torch.no_grad():
            phi, h, grad_norm, lp = self._phi(log_posterior,
                                              state.particles)
            # The optimizer descends; SVGD ascends the Stein direction.
            updates, opt_state = self._opt.update(
                {k: -v for k, v in phi.items()}, state.opt_state)
            particles = {k: v + updates[k]
                         for k, v in state.particles.items()}
        info = SVGDInfo(particles=particles, bandwidth=h,
                        grad_norm=grad_norm, log_prob=lp)
        return SVGDState(particles, opt_state, state.t + 1), info

    def run(self, meta_bn, observed, state: SVGDState, n_iters: int,
            collect: bool = False):
        """``n_iters`` updates in a Python loop.

        :param collect: keep each iteration's ``bandwidth`` and
            ``grad_norm`` (in device vectors; read the particles from the
            final state).
        :return: ``(final_state, {"bandwidth", "grad_norm"} or None)``.
        """
        n_iters = int(n_iters)
        outs = None
        for i in range(n_iters):
            state, info = self.update(meta_bn, observed, state)
            if collect:
                if outs is None:
                    outs = {f: getattr(info, f).new_empty((n_iters,))
                            for f in ("bandwidth", "grad_norm")}
                outs["bandwidth"][i] = info.bandwidth
                outs["grad_norm"][i] = info.grad_norm
        return state, outs


def state_from_numpy(numpy_state, device=None, dtype=None) -> SVGDState:
    """A port :class:`SVGDState` from a JAX one whose leaves went through
    ``np.asarray``: its ``optax.adagrad`` state (``(ScaleByRssState,
    EmptyState)``) becomes an :class:`AdagradState` of the same layout. On
    ``device`` (the
    card when None) in ``dtype`` (the arrays' own when None)."""
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)

    def arr(v):
        return torch.tensor(np.array(v), dtype=dtype, device=device)

    opt = numpy_state.opt_state
    if not hasattr(opt, "sum_of_squares"):
        opt = next(s for s in opt if hasattr(s, "sum_of_squares"))
    return SVGDState(
        particles={k: arr(v) for k, v in numpy_state.particles.items()},
        opt_state=AdagradState({k: arr(v)
                                for k, v in opt.sum_of_squares.items()}),
        t=int(np.asarray(numpy_state.t)))


def state_to_numpy(state: SVGDState) -> SVGDState:
    """The state with numpy leaves (``t`` an int32 scalar)."""

    def arr(v):
        return v.detach().cpu().numpy()

    return SVGDState(
        particles={k: arr(v) for k, v in state.particles.items()},
        opt_state=AdagradState({k: arr(v) for k, v in
                                state.opt_state.sum_of_squares.items()}),
        t=np.asarray(state.t, np.int32))
