"""The adaptation rules of the samplers under test, in plain torch scalars.

- Nesterov dual averaging of the step size (Hoffman & Gelman 2014, Alg. 5)
  with the ``mu = log(10 eps0)`` attractor: :class:`DualAveraging`.
- The exponentially weighted moving variance over chains that gives HMC's
  and NUTS's diagonal mass ``1 / var`` from ``mass_collect_iters`` on:
  :class:`MovingVariance`.
- ChEES's Adam ascent on ``log T`` (Hoffman, Radul & Sountsov 2021, Eq. 14)
  and the base-2 Halton jitter of the trajectory: :class:`ChEESLength`.

Each works in the dtype of its tensors, so the same code serves the
float64 reference and its lower-precision control.
"""

from __future__ import annotations

import math

import torch


class DualAveraging:
    """Step-size dual averaging; ``update`` returns the step of the next
    iteration (``exp(log eps)`` while adapting, ``exp(log eps bar)`` once
    frozen, the initial step if it never ran). Its arithmetic is written
    as one sequence of 0-d tensor operations, so that in float32 it rounds
    as the sampler's own float32 adaptation does."""

    def __init__(self, step0: float, dtype, device, target=0.8, gamma=0.05,
                 t0=100.0, kappa=0.75):
        self.mu = math.log(10.0 * step0)
        self.target, self.gamma, self.t0, self.kappa = target, gamma, t0, kappa

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)

        self.step, self.m = scalar(step0), scalar(0.0)
        self.h_bar, self.log_bar = scalar(0.0), scalar(0.0)

    def update(self, mean_accept, adapt: bool, restart: bool = False):
        frozen = torch.where(self.m > 0, torch.exp(self.log_bar), self.step)
        if not adapt:
            self.step = frozen
            return frozen
        fs = 1.0 if restart else 0.0
        mean_accept = torch.as_tensor(mean_accept).to(self.step.dtype)
        m = (1.0 - fs) * self.m + 1.0
        rate = 1.0 / (m + self.t0)
        self.h_bar = (1.0 - fs) * (1.0 - rate) * self.h_bar + rate * (
            self.target - mean_accept)
        log_eps = self.mu - torch.sqrt(m) / self.gamma * self.h_bar
        w = torch.pow(m, -self.kappa)
        self.log_bar = w * log_eps + (1.0 - fs) * (1.0 - w) * self.log_bar
        self.m = m
        self.step = torch.exp(log_eps)
        return self.step


class MovingVariance:
    """Bias-corrected EW mean and variance over the chain axis of ``[c, d]``
    positions; ``mass(t)`` is ``1 / var`` from ``collect_iters`` on."""

    def __init__(self, dim: int, dtype, device, decay=0.99,
                 collect_iters=50):
        self.decay, self.collect_iters = decay, collect_iters
        self.n = 0
        self.mean = torch.zeros(dim, dtype=dtype, device=device)
        self.var = torch.zeros(dim, dtype=dtype, device=device)

    def update(self, x):
        self.n += 1
        w = (1.0 - self.decay) / (1.0 - self.decay ** self.n)
        incr = w * (x.to(self.mean.dtype) - self.mean)
        self.mean = self.mean + incr.mean(dim=0)
        self.var = (1.0 - w) * self.var + (
            incr * (x.to(self.mean.dtype) - self.mean)).mean(dim=0)

    def mass(self, t: int):
        """The mass iteration ``t`` runs with."""
        if t >= self.collect_iters and self.n > 0:
            return 1.0 / torch.clamp(self.var, min=1e-20)
        return torch.ones_like(self.var)


def halton2(t: int) -> float:
    """Base-2 radical inverse of the 32-bit counter ``t``."""
    bits = format(int(t) & 0xFFFFFFFF, "032b")
    return int(bits[::-1], 2) * 2.0 ** -32


class ChEESLength:
    """Adam (0.9, 0.95) on ``log T`` along the ChEES gradient, each move
    clipped to 0.5, ``log T`` kept within ``[log eps, log(eps
    max_leapfrogs)]``; 0-d tensor arithmetic in the order of the sampler's
    own, so that in float32 it rounds as the sampler does."""

    def __init__(self, traj0: float, dtype, device, lr=0.05,
                 max_leapfrogs=1000):
        self.lr, self.max_leapfrogs = lr, max_leapfrogs

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)

        self.log_traj = scalar(math.log(traj0))
        self.m, self.v, self.n = scalar(0.0), scalar(0.0), scalar(0.0)

    @staticmethod
    def jitter(t: int, dtype) -> float:
        """The trajectory's share of ``T`` at state counter ``t`` (the
        Halton value rounded to ``dtype``, at least 1/64)."""
        h = float(torch.tensor(halton2(t), dtype=torch.float64).to(dtype))
        return max(h, 1.0 / 64.0)

    def n_steps(self, jitter: float, step) -> int:
        r = torch.nan_to_num(torch.ceil(jitter * torch.exp(self.log_traj)
                                        / step), nan=1.0)
        return int(torch.clamp(r, 1, self.max_leapfrogs))

    @staticmethod
    def gradient(q, prop_q, prop_p, accept, jitter: float, dtype):
        """The ChEES gradient on ``log T`` in ``dtype``: acceptance-weighted
        change in the squared distance from the weighted means, times the
        endpoint velocity (unit mass); 0 where it is not finite. A
        trajectory that leaves ``dtype``'s range makes it infinite there,
        and the iteration's gradient is dropped, as the sampler drops it."""
        q, prop_q, prop_p, accept = (x.to(dtype) for x in (q, prop_q, prop_p,
                                                           accept))
        w = accept / torch.clamp(torch.sum(accept), min=1e-12)
        mean_q = torch.sum(w[:, None] * q, dim=0, keepdim=True)
        mean_nq = torch.sum(w[:, None] * prop_q, dim=0, keepdim=True)
        dq = prop_q - mean_nq
        jump = torch.sum(dq * dq, dim=1) - torch.sum((q - mean_q) ** 2, dim=1)
        djump = 2.0 * torch.sum(dq * prop_p, dim=1)
        g = torch.sum(w * jump * djump) * jitter
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))

    def update(self, grad, step, adapt: bool):
        if adapt:
            self.n = self.n + 1.0
            self.m = 0.9 * self.m + (1 - 0.9) * grad
            self.v = 0.95 * self.v + (1 - 0.95) * grad ** 2
            safe = torch.clamp(self.n, min=1.0)
            m_hat = self.m / (1 - 0.9 ** safe)
            v_hat = self.v / (1 - 0.95 ** safe)
            delta = self.lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            self.log_traj = self.log_traj + torch.clamp(delta, -0.5, 0.5)
        self.log_traj = torch.clamp(
            self.log_traj, min=torch.log(step),
            max=torch.log(step * self.max_leapfrogs))
        return torch.exp(self.log_traj)
