"""What the plain samplers share: the configuration's target found by
name, the leapfrog integrator, the Metropolis step, and the numbers that
compare a run with the reference."""

from __future__ import annotations

import importlib

import torch


def target_of(config):
    """The plain side of the configuration's target,
    ``reference/targets/<target>.py``: ``dim``, ``density``, ``scale``
    and ``cost`` of ``config``."""
    return importlib.import_module("benchmark.reference.targets."
                                   + config["target"])


def position_before(job, t: int):
    """The program's position before iteration ``t`` (counted from 1 over
    the collected warm-up and sampling draws)."""
    if t == 1:
        return job["q0"]
    nw = job["warm_samples"].shape[0]
    return (job["warm_samples"][t - 2] if t - 1 <= nw
            else job["samples"][t - 2 - nw])


def draw_of(job, t: int):
    """The program's draw of iteration ``t``."""
    nw = job["warm_samples"].shape[0]
    return (job["warm_samples"][t - 1] if t <= nw
            else job["samples"][t - 1 - nw])


def leapfrog(target, q, p, step, n: int, inv_mass):
    """``n`` leapfrog steps (a half kick, then ``n`` drifts with full kicks
    between them, then a half kick); ``n = 0`` is the half kick alone."""
    p = p + 0.5 * step * target.grad(q)
    for i in range(n):
        q = q + step * p * inv_mass
        p = p + (step if i < n - 1 else 0.5 * step) * target.grad(q)
    return q, p


def energy(target, q, p, inv_mass):
    """``(H, log p)`` per chain."""
    lp = target.log_prob(q)
    return -lp + 0.5 * (p * p * inv_mass).sum(dim=-1), lp


def metropolis(target, q, p, u, step, n: int, inv_mass):
    """One HMC transition from momentum ``p`` and uniforms ``u``:
    ``(kept q, acceptance, proposal q, proposal p)``; a non-finite energy
    is rejected."""
    h0, _ = energy(target, q, p, inv_mass)
    pq, pp = leapfrog(target, q, p, step, n, inv_mass)
    h1, lp1 = energy(target, pq, pp, inv_mass)
    acc = torch.exp(torch.clamp(h0 - h1, max=0.0))
    acc = torch.where(torch.isfinite(acc) & torch.isfinite(lp1), acc,
                      torch.zeros_like(acc))
    take = (u.to(acc.dtype) < acc)[:, None]
    return torch.where(take, pq, q), acc, pq, pp


def off_share(got, want, std, tol: float, got_acc=None, want_acc=None,
              acc_tol: float = 0.0):
    """Share of chains (rows) with a coordinate off by more than ``tol``
    times the target's scale ``std``, or with an acceptance statistic off by
    more than ``acc_tol`` where both are given; non-finite is off."""
    gap = ((got.to(torch.float64) - want.to(torch.float64)).abs()
           / std.to(torch.float64))
    bad = ~(gap <= tol).all(dim=1)
    if got_acc is not None:
        acc_gap = (got_acc.to(torch.float64) - want_acc.to(torch.float64))
        bad = bad | ~(acc_gap.abs() <= acc_tol)
    return float(bad.to(torch.float64).mean())


def rel_gap(got, want) -> float:
    """Largest ``|got / want - 1|`` (infinite where ``got`` is not finite)."""
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64).to(got.device)
    gap = (got / want - 1.0).abs()
    gap = torch.where(torch.isfinite(gap), gap,
                      torch.full_like(gap, float("inf")))
    return float(gap.max())

