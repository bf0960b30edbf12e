"""L-BFGS with the zoom line search: the port's copy of ``optax.lbfgs()``.

Laplace (:mod:`.laplace`) and Pathfinder (:mod:`.pathfinder`) drive
``optax.lbfgs()`` in the JAX package, and Pathfinder builds its
approximations from EVERY iterate of the optimisation, so the port
reproduces optax 0.2.6's iterates, not just a minimum:

- :func:`lbfgs` is ``optax.lbfgs()`` (``_src/alias.py``): the two-loop
  preconditioner ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
  (``_src/transform.py``), a sign flip, and ``scale_by_zoom_linesearch(
  max_linesearch_steps=20, initial_guess_strategy='one')``
  (``_src/linesearch.py``): Nocedal & Wright's interval search and zoom
  (Algorithms 3.5, 3.6) with Hager & Zhang's approximate decrease test,
  cubic / quadratic / bisection trial points, and the safe-step fallback;
- :func:`value_and_grad_from_state` is ``optax.value_and_grad_from_state``:
  it reuses the value and gradient the line search stored at the point it
  chose.

Everything works on ONE flat tensor. The preconditioner stays on the
tensor's device. The line search's ``while_loop`` and its branches become a
Python loop whose decisions are taken on the host: each line-search step
reads the trial point's value and slope (one host read), and the search's
start reads the initial slope (one more), so an iteration makes
``1 + num_linesearch_steps`` reads (``LinesearchInfo.host_reads``). The
line search's scalars are float64 on the host whatever the tensor's dtype
(in float64 they are optax's own numbers).

Shape of the optimizer (optax's): ``init(x) -> state``, ``update(grad,
state, x, *, value, grad, value_fn) -> (updates, state)``, the new point
being ``x + updates``. ``value_fn(x)`` returns a scalar tensor and must be
differentiable by autograd.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["LBFGSState", "LinesearchInfo", "LinesearchOptimizer", "lbfgs",
           "value_and_grad", "value_and_grad_from_state"]

_F64 = np.float64


class LinesearchInfo(NamedTuple):
    """The last line search (optax's ``ZoomLinesearchInfo`` plus the host
    reads it made)."""

    num_linesearch_steps: int
    decrease_error: float
    curvature_error: float
    host_reads: int


class LBFGSState(NamedTuple):
    """optax's ``(ScaleByLBFGSState, EmptyState, ScaleByZoomLinesearchState)``
    in one tuple. ``count``, ``learning_rate`` and ``value`` live on the
    host."""

    count: int
    params: torch.Tensor  # the point of the last update
    updates: torch.Tensor  # the gradient there
    diff_params_memory: torch.Tensor  # [m, D]
    diff_updates_memory: torch.Tensor  # [m, D]
    weights_memory: torch.Tensor  # [m]
    learning_rate: float
    value: float  # +inf until the first line search ends
    grad: torch.Tensor
    info: LinesearchInfo


class LinesearchOptimizer(NamedTuple):
    """``init`` and ``update`` in optax's shape for an optimizer that takes
    the objective (see the module docstring)."""

    init: Callable
    update: Callable


def value_and_grad(fn, x):
    """``(fn(x), d fn / d x)`` by autograd, both detached."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        value = fn(leaf)
        (grad,) = torch.autograd.grad(value, leaf)
    return value.detach(), grad


def value_and_grad_from_state(value_fn):
    """``(x, *, state) -> (value, grad)``: the line search's stored value
    and gradient when the stored value is finite, else ``value_fn``'s by
    autograd (``optax.value_and_grad_from_state``). The returned value is a
    host float when it comes from the state, a 0-dim tensor otherwise."""

    def from_state(x, *, state):
        if np.isfinite(state.value):
            return state.value, state.grad
        return value_and_grad(value_fn, x)

    return from_state


def _host(*values):
    """Float64 host scalars of ``values``: the 0-dim tensors among them
    read in one transfer, host numbers as they are."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([t.to(torch.float64).reshape(())
                             for t in tensors]).tolist() if tensors else [])
    return [_F64(next(read) if isinstance(v, torch.Tensor) else v)
            for v in values]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax ``linesearch.py::_cubicmin``: the critical point of the cubic
    through ``(a, fa)``, ``(b, fb)``, ``(c, fc)`` with slope ``fpa`` at
    ``a`` (NaN when there is none)."""
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r1 = fb - fa - cc * db
    r2 = fc - fa - cc * dc
    a_ = (dc * dc * r1 + -(db * db) * r2) / denom
    b_ = (-(dc * (dc * dc)) * r1 + db * (db * db) * r2) / denom
    radical = b_ * b_ - 3.0 * a_ * cc
    return a + (-b_ + np.sqrt(radical)) / (3.0 * a_)


def _quadmin(a, fa, fpa, b, fb):
    """optax ``linesearch.py::_quadmin``: the critical point of the
    quadratic through ``(a, fa)``, ``(b, fb)`` with slope ``fpa`` at
    ``a``."""
    db = b - a
    b_ = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * b_)


class _Point(NamedTuple):
    """A trial point of the line search: its step size, value, gradient
    and slope along the direction."""

    stepsize: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64


def _zoom_linesearch(params, updates, value, grad, value_fn,
                     max_linesearch_steps=20, increase_factor=2.0,
                     slope_rtol=1e-4, curv_rtol=0.9, approx_dec_rtol=1e-6,
                     interval_threshold=1e-5, tol=0.0):
    """optax ``zoom_linesearch`` with ``initial_guess_strategy='one'`` and
    no maximal step: returns ``(stepsize, value, grad, info)`` at the
    chosen step along ``updates`` from ``params``."""
    value_init, slope_init = _host(value, torch.dot(updates, grad))
    reads = 1

    def on_line(stepsize):
        nonlocal reads
        v, g = value_and_grad(value_fn,
                               params + float(stepsize) * updates)
        v, s = _host(v, torch.dot(g, updates))
        reads += 1
        return _Point(stepsize, v, g, s)

    def errors(p):
        """optax's decrease and curvature errors, NaN counted as inf."""
        dec = p.value - value_init - slope_rtol * p.stepsize * slope_init
        approx = p.slope - (2 * slope_rtol - 1.0) * slope_init
        delta = p.value - value_init - approx_dec_rtol * np.abs(value_init)
        dec = np.maximum(np.minimum(np.maximum(approx, delta), dec), 0.0)
        curv = np.maximum(np.abs(p.slope) - curv_rtol * np.abs(slope_init),
                          0.0)
        return (_F64(np.inf) if np.isnan(dec) else dec,
                _F64(np.inf) if np.isnan(curv) else curv)

    init = _Point(_F64(0.0), value_init, grad, slope_init)
    cur = init
    safe = init  # the safeguard: sufficient decrease at least
    low = high = cubic_ref = init
    interval_found = done = failed = False
    dec_err = curv_err = _F64(np.inf)
    count = 0
    while not (done or failed):
        if not interval_found:
            # Algorithm 3.5 of Nocedal & Wright: grow the step.
            new = on_line(_F64(1.0) if count == 0
                          else increase_factor * cur.stepsize)
            dec_err, curv_err = errors(new)
            error = np.maximum(dec_err, curv_err)
            if dec_err <= tol:
                safe = new
            set_high = dec_err > 0.0 or (new.value >= cur.value
                                         and count > 0)
            set_low = new.slope >= 0.0 and not set_high
            low, high = (new, cur) if set_low else (cur, new)
            cubic_ref = low
            interval_found = set_high or set_low or error <= tol
            done = error <= tol
            failed = count + 1 >= max_linesearch_steps and not done
            cur = new
        else:
            # Algorithm 3.6: zoom into [low, high].
            delta = np.abs(high.stepsize - low.stepsize)
            left = min(high.stepsize, low.stepsize)
            right = max(high.stepsize, low.stepsize)
            too_small = delta <= interval_threshold
            with np.errstate(all="ignore"):
                mid_c = _cubicmin(low.stepsize, low.value, low.slope,
                                  high.stepsize, high.value,
                                  cubic_ref.stepsize, cubic_ref.value)
                mid_q = _quadmin(low.stepsize, low.value, low.slope,
                                 high.stepsize, high.value)
            if left + 0.2 * delta < mid_c < right - 0.2 * delta:
                middle = mid_c
            elif left + 0.1 * delta < mid_q < right - 0.1 * delta:
                middle = mid_q
            else:
                middle = (low.stepsize + high.stepsize) / 2.0
            mid = on_line(_F64(middle))
            dec_err, curv_err = errors(mid)
            error = np.maximum(dec_err, curv_err)
            if dec_err <= tol and mid.value < safe.value:
                safe = mid
            done = error <= tol
            set_high_mid = dec_err > 0.0 or mid.value >= low.value
            set_high_low = (mid.slope * (high.stepsize - low.stepsize) >= 0.0
                            and not set_high_mid)
            old_low, old_high = low, high
            if set_high_mid:
                high = mid
            elif set_high_low:
                high = old_low
            if not set_high_mid:
                low = mid
            cubic_ref = old_high if (set_high_mid or set_high_low) \
                else old_low
            failed = ((count + 1 >= max_linesearch_steps
                       or (too_small and safe.stepsize > 0.0)) and not done)
            cur = mid
        count += 1
        if failed and (safe.stepsize > 0.0 or np.isinf(dec_err)):
            cur = cur._replace(stepsize=safe.stepsize, value=safe.value,
                               grad=safe.grad)
    info = LinesearchInfo(count, float(dec_err), float(curv_err), reads)
    return cur.stepsize, cur.value, cur.grad, info


def _precondition(updates, dw, du, rhos, identity_scale, memory_idx):
    """optax ``_precondition_by_lbfgs``: the two-loop recursion (Nocedal &
    Wright, Algorithm 7.4) over the memory, newest pair last."""
    m = rhos.shape[0]
    order = [(memory_idx + i) % m for i in range(m)]
    vec = updates
    alphas = {}
    for idx in reversed(order):
        alphas[idx] = rhos[idx] * torch.dot(dw[idx], vec)
        vec = vec + (-alphas[idx]) * du[idx]
    vec = identity_scale * vec
    for idx in order:
        beta = rhos[idx] * torch.dot(du[idx], vec)
        vec = vec + (alphas[idx] - beta) * dw[idx]
    return vec


def lbfgs(memory_size: int = 10, scale_init_precond: bool = True,
          max_linesearch_steps: int = 20) -> LinesearchOptimizer:
    """``optax.lbfgs()`` at its defaults (optax 0.2.6), on a flat tensor:
    the L-BFGS direction (memory ``memory_size``; the identity scaled by
    ``s^T y / y^T y``, and by ``min(1, 1 / ||g||)`` at the first step), then
    the zoom line search from a unit step."""
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    m = int(memory_size)

    def init(x):
        zeros = torch.zeros((m,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
        return LBFGSState(
            count=0, params=torch.zeros_like(x), updates=torch.zeros_like(x),
            diff_params_memory=zeros, diff_updates_memory=zeros.clone(),
            weights_memory=torch.zeros(m, dtype=x.dtype, device=x.device),
            learning_rate=1.0, value=float("inf"), grad=torch.zeros_like(x),
            info=LinesearchInfo(0, float("inf"), float("inf"), 0))

    def update(updates, state, params, *, value, grad, value_fn):
        count = state.count
        memory_idx, prev_idx = count % m, (count - 1) % m
        # 1. the newest (s, y) pair and its weight 1 / (y^T s).
        if count > 0:
            diff_params = params - state.params
            diff_updates = updates - state.updates
            ys = torch.dot(diff_updates, diff_params)
            weight = torch.where(ys == 0.0, torch.zeros_like(ys), 1.0 / ys)
        else:
            diff_params = torch.zeros_like(params)
            diff_updates = torch.zeros_like(updates)
            weight = torch.zeros((), dtype=params.dtype, device=params.device)
        dw = state.diff_params_memory.clone()
        du = state.diff_updates_memory.clone()
        rhos = state.weights_memory.clone()
        dw[prev_idx], du[prev_idx], rhos[prev_idx] = (diff_params,
                                                      diff_updates, weight)
        # 2. the scale of the initial inverse Hessian.
        if not scale_init_precond:
            identity_scale = 1.0
        elif count > 0:
            num = torch.dot(diff_updates, diff_params)
            den = torch.sum(diff_updates * diff_updates)
            identity_scale = torch.where(den > 0.0, num / den,
                                         torch.ones_like(num))
        else:
            norm = torch.sqrt(torch.sum(updates * updates))
            identity_scale = torch.clamp(1.0 / norm, max=1.0)
        # 3. the direction -P g, then the line search along it.
        direction = -1.0 * _precondition(updates, dw, du, rhos,
                                         identity_scale, memory_idx)
        stepsize, ls_value, ls_grad, info = _zoom_linesearch(
            params, direction, value, grad, value_fn,
            max_linesearch_steps=max_linesearch_steps)
        new_state = LBFGSState(
            count=count + 1, params=params, updates=updates,
            diff_params_memory=dw, diff_updates_memory=du,
            weights_memory=rhos, learning_rate=float(stepsize),
            value=float(ls_value), grad=ls_grad, info=info)
        return float(stepsize) * direction, new_state

    return LinesearchOptimizer(init, update)
