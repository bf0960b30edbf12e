"""Plain ChEES-HMC and the numbers that compare the program's job with it.

An iteration ``t`` (counted from 1): the trajectory time is
``h T`` with ``h`` the Halton jitter of ``t - 1`` and ``T`` the current
trajectory length; ``clip(ceil(h T / eps), 1, max_leapfrogs)`` leapfrog
steps with unit mass, Philox momentum and a Metropolis test; the step size
follows dual averaging on the harmonic mean of the chains' acceptance (one
restart, at the start), and while adapting ``log T`` takes an Adam step
along the ChEES gradient of the proposals (:mod:`.adapt`).

The check follows the program step by step from its own collected
positions and acceptance: the step sizes are worked out again by dual
averaging on the program's per-iteration acceptance (the harmonic mean
over chains, dominated by the least acceptances, makes the adaptation
amplify any rounding of its own: run on the reference's acceptance it
leaves the program's path within some tens of iterations); every warm-up
iteration is rebuilt from the program's position before it (the ChEES
gradient needs every chain's proposal), which gives the acceptance, the
leapfrog counts and the trajectory lengths anew; and
``check_iterations`` sampling iterations drawn from the run's seed, with
the first, are rebuilt too. The leapfrog count of a rebuilt iteration is
the program's own, so that one count off by one at a rounding boundary
does not move a whole iteration; ``leapfrog_gap`` holds the counts to the
worked-out ones.
"""

from __future__ import annotations

import random

import torch

from benchmark.reference import philox
from benchmark.reference.adapt import ChEESLength, DualAveraging
from benchmark.reference.common import (
    draw_of,
    metropolis,
    off_share,
    position_before,
    rel_gap,
    target_of,
)
from benchmark.reference.ess import ess_gap, ess_total


def _step(job, t, target, step, n, dtype):
    q = position_before(job, t).to(dtype)
    c, d = q.shape
    p = philox.normals(job["key"], t, c, d, device=q.device, dtype=dtype)
    u = philox.mh_uniforms(job["key"], t, c, device=q.device)
    ones = torch.ones(d, dtype=dtype, device=q.device)
    return q, metropolis(target, q, p, u, step, n, ones)


def _counts(job):
    return torch.cat([job["warm_leapfrogs"], job["leapfrogs"]]).tolist()


def _plan(cell, seed_words):
    rng = random.Random(seed_words)
    nw, ns, k = cell["n_warmup"], cell["n_sample"], cell["check_iterations"]
    picks = {nw + 1}
    picks.update(rng.sample(range(nw + 2, nw + ns + 1), min(k, ns - 1)))
    return sorted(picks)


class _Warmup:
    """Every warm-up iteration rebuilt in ``dtype`` from the position
    before it in ``job``, with the step size that dual averaging gives on
    the acceptance of the iterations before; ``counts`` (the program's
    leapfrog counts) replace the worked-out ones when given. With
    ``write``, each iteration's draw, acceptance, count and trajectory
    length are written into ``job`` before the adaptation reads them, so
    that the warm-up runs on its own path.

    The adaptation (dual averaging, the harmonic mean, Adam on ``log T``)
    runs in the configuration's precision, float32, or ``dtype`` where
    that is lower: its harmonic mean is dominated by the least acceptances,
    and near the step at which the narrowest scale turns unstable one
    rounding moves the trajectories, so a float64 adaptation leaves the
    float32 one's path however right both are."""

    def __init__(self, job, cell, config, dtype, counts=None, write=False):
        args = cell["args"]
        dev = job["q0"].device
        self.job, self.n, self.dtype, self.counts, self.write = (
            job, cell["n_warmup"], dtype, counts, write)
        self.adapt_dtype = (torch.float32 if dtype == torch.float64
                            else dtype)
        self.target = target_of(config).density(config, dev, dtype)
        self.da = DualAveraging(
            args["step_size"], self.adapt_dtype, dev,
            target=args.get("target_acceptance_rate", 0.651))
        self.tl = ChEESLength(args.get("trajectory_length", 1.0),
                              self.adapt_dtype, dev,
                              lr=args.get("traj_learning_rate", 0.05),
                              max_leapfrogs=args.get("max_leapfrogs", 1000))
        self.step = self.da.step

    def __iter__(self):
        """``(t, worked-out count, kept draws, acceptance, trajectory
        length)``."""
        job = self.job
        for t in range(1, self.n + 1):
            jitter = self.tl.jitter(t - 1, torch.float32)
            own = self.tl.n_steps(jitter, self.step)
            n = own if self.counts is None else self.counts[t - 1]
            q, (kept, acc, pq, pp) = _step(job, t, self.target, self.step, n,
                                           self.dtype)
            if self.write:
                job["warm_samples"][t - 1] = kept
                job["warm_accept"][t - 1] = acc
                job["warm_leapfrogs"][t - 1] = n
            prog = job["warm_accept"][t - 1].to(self.adapt_dtype)
            harmonic = 1.0 / torch.mean(1.0 / torch.clamp(prog, min=1e-10))
            self.step = self.da.update(harmonic, True, restart=(t == 1))
            grad = self.tl.gradient(q, pq, pp, acc, jitter, self.adapt_dtype)
            length = self.tl.update(grad, self.step, True)
            if self.write:
                job["warm_length"][t - 1] = length
            yield t, own, kept, acc, length


def check(job, cell, config):
    f64 = torch.float64
    dev = job["q0"].device
    std = target_of(config).scale(config).to(dev)
    counts = _counts(job)
    warm = _Warmup(job, cell, config, f64, counts)
    worst, n_gap, lengths = 0.0, 0, []
    for t, own, kept, acc, length in warm:
        n_gap = max(n_gap, abs(own - counts[t - 1]))
        worst = max(worst, off_share(
            draw_of(job, t), kept, std, cell["draw_tol"],
            job["warm_accept"][t - 1], acc, cell["accept_tol"]))
        lengths.append(length)
    out = {"leapfrog_gap": float(n_gap),
           "traj_gap": rel_gap(job["warm_length"], torch.stack(lengths))}
    frozen = warm.da.update(None, False)
    out["step_size_gap"] = rel_gap(job["step_size"], frozen)
    for t in _plan(cell, job["check_seed"]):
        use = warm.step if t == cell["n_warmup"] + 1 else frozen
        _, (kept, acc, _, _) = _step(job, t, warm.target, use,
                                     counts[t - 1], f64)
        worst = max(worst, off_share(
            draw_of(job, t), kept, std, cell["draw_tol"],
            job["accept"][t - 1 - cell["n_warmup"]], acc, cell["accept_tol"]))
    out["draws_off"] = worst
    draws = job["samples"]
    out["ess_gap"] = ess_gap(draws, job["ess"], draws.shape[1])
    return out


def stand_in(job, cell, config, dtype):
    """The job with the reference in ``dtype`` put in the program's place
    wherever the check reads it: the whole warm-up run in ``dtype`` on its
    own path from the job's starting points, its draws, acceptance, counts
    and trajectory lengths written over the program's; the chosen sampling
    iterations rebuilt in ``dtype`` from the position before each, with
    the program's counts; the frozen step and the ESS in ``dtype``."""
    rec = dict(job)
    for name in ("warm_samples", "samples", "warm_accept", "accept",
                 "warm_leapfrogs", "warm_length"):
        rec[name] = job[name].clone()
    warm = _Warmup(rec, cell, config, dtype, write=True)
    for _ in warm:
        pass
    frozen = warm.da.update(None, False)
    counts, nw = _counts(rec), cell["n_warmup"]
    for t in _plan(cell, job["check_seed"]):
        use = warm.step if t == nw + 1 else frozen
        _, (kept, acc, _, _) = _step(rec, t, warm.target, use, counts[t - 1],
                                     dtype)
        rec["samples"][t - 1 - nw], rec["accept"][t - 1 - nw] = kept, acc
    rec["step_size"] = frozen
    rec["ess"] = ess_total(rec["samples"], rec["samples"].shape[1], dtype)
    return rec
