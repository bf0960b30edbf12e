"""Plain HMC with step-size and diagonal-mass adaptation, replayed over a
whole job from the same starting points and noise as the program, and the
numbers that compare the program's job with it.

An iteration ``t`` (counted from 1 over the warm-up and the sampling run):
while adapting, the moving variance takes the current positions and the
mass becomes ``1 / var`` from ``mass_collect_iters`` on; at ``t = 1`` and
``t = mass_collect_iters`` the step size is searched afresh (one leapfrog
step with momentum drawn from a generator seeded by ``splitmix(key, t)``,
the step scaled by 1.5 until the mean acceptance crosses the target) and
the dual averaging restarts; then ``n_leapfrogs`` steps with Philox
momentum ``N(0, 1) sqrt(m)`` and a Metropolis test, and a dual-averaging
update on the mean acceptance. Sampling freezes both.

The warm-up is replayed for every chain from the job's own starting
points, as the adaptation couples the chains through their mean
acceptance and the variance over chains; its end's step size and mass
are compared with the program's. Its end's positions are not: chains
that start some hundred standard deviations out have float32 energies of
1e5 and more, rounded by tenths, so the program's early acceptances, and
with them its path, leave the float64 replay's within tens of iterations;
the shared noise draws the paths together again, but on some seeds not
all the way by the warm-up's end, while the adapted step size and mass,
averages over every chain, agree. The sampling run is replayed from the
program's own state at the warm-up's end, where the chains no longer
interact. A chain whose Metropolis test falls within rounding of its
uniform may take the other branch than the program's; it then tends to
rejoin, since both see the same noise, and ``draws_off`` counts it while
it is apart.
"""

from __future__ import annotations

import torch

from benchmark.reference import philox
from benchmark.reference.adapt import DualAveraging, MovingVariance
from benchmark.reference.common import (
    energy,
    leapfrog,
    metropolis,
    off_share,
    rel_gap,
    target_of,
)
from benchmark.reference.ess import ess_gap, ess_total


def _search(target, q, p, step, inv_mass, goal: float):
    """The heuristic initial step size (one leapfrog step a trial)."""
    below_last = 1.0 < goal
    while True:
        h0, _ = energy(target, q, p, inv_mass)
        nq, np_ = leapfrog(target, q, p, step, 1, inv_mass)
        h1, lp1 = energy(target, nq, np_, inv_mass)
        acc = torch.exp(torch.clamp(h0 - h1, max=0.0))
        acc = torch.where(torch.isfinite(acc) & torch.isfinite(lp1), acc,
                          torch.zeros_like(acc))
        below = bool(acc.mean() < goal)
        new = step / 1.5 if below else step * 1.5
        if below != below_last:
            return new
        step, below_last = new, below


def warmup(args, target, key, q0, n_warm: int, dtype):
    """The adapting iterations from ``q0``: ``(q, step, log_step_bar,
    mass)`` at their end."""
    dev = q0.device
    c, d = q0.shape
    goal = args.get("target_acceptance_rate", 0.8)
    da = DualAveraging(args["step_size"], dtype, dev, target=goal)
    collect = args["mass_collect_iters"]
    mv = MovingVariance(d, dtype, dev, collect_iters=collect)
    step, mass = da.step, None
    q = q0.to(dtype)
    for t in range(1, n_warm + 1):
        mv.update(q)
        mass = mv.mass(t)
        restart = t in (1, collect)
        if restart:
            g = torch.Generator(device=dev)
            g.manual_seed(philox.splitmix(key, t))
            e = torch.randn((c, d), generator=g, dtype=torch.float32,
                            device=dev)
            step = _search(target, q, e.to(dtype) * torch.sqrt(mass), step,
                           1.0 / mass, goal)
        q, acc = _transition(args, target, key, t, q, step, mass, dtype)
        step = da.update(acc.mean(), True, restart)
    return q, step, da.log_bar, mass


def _transition(args, target, key, t, q, step, mass, dtype):
    c, d = q.shape
    p = philox.normals(key, t, c, d, device=q.device, dtype=dtype) \
        * torch.sqrt(mass)
    u = philox.mh_uniforms(key, t, c, device=q.device)
    q, acc, _, _ = metropolis(target, q, p, u, step, args["n_leapfrogs"],
                              1.0 / mass)
    return q, acc


def sample(args, target, key, state, t0: int, n_samp: int, dtype):
    """Yield the positions of the frozen iterations ``t0 + 1 ..`` from a
    warm-up's end ``state = (q, step, log_step_bar, mass)``: the first
    runs with the last adapting step, the rest with ``exp(log_step_bar)``."""
    q, step, log_bar, mass = (torch.as_tensor(x).to(dtype) for x in state)
    mass = mass.reshape(-1)
    for t in range(t0 + 1, t0 + n_samp + 1):
        q, _ = _transition(args, target, key, t, q, step, mass, dtype)
        step = torch.exp(log_bar)
        yield q


def _program_state(job):
    return job["warm_q"], job["step_size"], job["log_step_bar"], job["mass"]


def check(job, cell, config):
    """The numbers of the program's job against the float64 reference:
    the warm-up replayed from the job's starting points, and the sampling
    replayed from the program's own state at the warm-up's end."""
    q0 = job["q0"]
    f64 = torch.float64
    plain = target_of(config)
    std = plain.scale(config).to(q0.device)
    target = plain.density(config, q0.device, f64)
    args, nw = cell["args"], cell["n_warmup"]
    _, step, _, mass = warmup(args, target, job["key"], q0, nw, f64)
    out = {"step_size_gap": rel_gap(job["step_size"], step),
           "mass_gap": rel_gap(job["mass"].reshape(-1), mass)}
    draws = job["samples"]
    c = draws.shape[1]
    worst = 0.0
    for i, q in enumerate(sample(args, target, job["key"], _program_state(job),
                                 nw, cell["n_sample"], f64)):
        worst = max(worst, off_share(draws[i], q, std, cell["draw_tol"]))
    out["draws_off"] = worst
    out["ess_gap"] = ess_gap(draws, job["ess"], c)
    return out


def stand_in(job, cell, config, dtype):
    """The job as the reference computes it in ``dtype``, put in the
    program's place: the whole warm-up from the job's starting points and
    noise, the sampling from that warm-up's end, the draws in the cell's
    collect dtype, and the ESS in ``dtype``."""
    q0, key = job["q0"], job["key"]
    target = target_of(config).density(config, q0.device, dtype)
    args, nw = cell["args"], cell["n_warmup"]
    state = warmup(args, target, key, q0, nw, dtype)
    collect = job["samples"].dtype
    draws = torch.stack([q.to(collect) for q in sample(
        args, target, key, state, nw, cell["n_sample"], dtype)])
    q, step, log_bar, mass = state
    return {**job, "warm_q": q, "step_size": step, "log_step_bar": log_bar,
            "mass": mass, "samples": draws,
            "ess": ess_total(draws, draws.shape[1], dtype)}
