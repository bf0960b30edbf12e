"""Plain NUTS (multinomial, generalized U-turn, iterative subtrees) and
the numbers that compare the program's job with it.

One transition from ``q0``: momentum ``N(0, 1) / sqrt(inv_mass)``; each
doubling ``k`` goes right when its direction uniform is below 0.5 and
builds ``2**k`` leaves from that edge. Within the subtree a leaf is taken
when ``log u_leaf < w - logsumexp(w so far)`` (``w = -H``, ``-inf`` for a
divergent leaf, ``H - H0 > max_delta_energy`` or NaN); a checkpoint of
the momentum and of the momentum sum before it is kept at slot
``popcount(i >> 1)`` for each even leaf ``i``, and an odd leaf checks the
``trailing_ones(i)`` subtrees that end at it. A subtree that did not turn
or diverge is merged, its proposal taken when ``log u_merge < W_sub - W``,
and the whole trajectory is checked for a U-turn. The acceptance statistic
is the mean of ``min(1, exp(H0 - H))`` over the leaves built. The noise
comes from Philox (:mod:`.philox`), the leaf uniforms numbered across the
tree (doubling ``k`` holds leaves ``2**k - 1 .. 2**(k+1) - 2``).

The check follows the program step by step from its own collected
positions (every warm-up and sampling draw is collected in float32):
the step sizes are worked out again by dual averaging on the program's
per-iteration acceptance statistics, the mass by the moving variance over
the program's warm-up positions, and chosen iterations are rebuilt from
the program's position before them, including the first warm-up iteration
(from the job's starting points) and the first sampling iteration. A
rebuilt iteration takes the step the program took there (the step it
collected the iteration before), which ``step_size_gap`` holds to the
worked-out one: where the trees first grow in the warm-up, the narrowest
scale's leapfrog sits near its stability edge (step over std about 1.9)
and chains start far out, so the float32 rounding of the step alone, some
1e-7 of it, sends 1-4% of the chains to other leaves.
"""

from __future__ import annotations

import math
import random

import torch

from benchmark.reference import philox
from benchmark.reference.adapt import DualAveraging, MovingVariance
from benchmark.reference.common import (
    draw_of,
    off_share,
    position_before,
    rel_gap,
    target_of,
)
from benchmark.reference.ess import ess_gap, ess_total


def _trailing_ones(i: int) -> int:
    n = i + 1
    return ((n & -n) - 1).bit_count()


def noise(key, t: int, c: int, d: int, depth: int, device):
    return (philox.normals(key, t, c, d, device=device),
            philox.uniform_rows(key, t, c, depth, philox.STREAM_NUTS_DIRECTION,
                                device),
            philox.uniform_rows(key, t, c, (1 << depth) - 1,
                                philox.STREAM_NUTS_LEAF, device),
            philox.uniform_rows(key, t, c, depth, philox.STREAM_NUTS_MERGE,
                                device))


def transition(target, q0, inv_mass, step, depth: int, max_delta: float,
               draws, dtype):
    """One transition of every chain in ``dtype``:
    ``(q', accept_stat, n_leapfrogs)``."""
    eps_n, u_dir, u_leaf, u_merge = (x.to(dtype) for x in draws)
    q0, inv_mass = q0.to(dtype), inv_mass.to(dtype)
    step = torch.as_tensor(step).to(dtype)
    c, d = q0.shape
    dev = q0.device
    p0 = eps_n / torch.sqrt(inv_mass)

    def ham(q, p):
        return -target.log_prob(q) + 0.5 * (p * p * inv_mass).sum(dim=-1)

    h0 = ham(q0, p0)
    log_leaf, log_merge = torch.log(u_leaf), torch.log(u_merge)
    neg_inf = torch.full_like(h0, -math.inf)
    zero = torch.zeros_like(h0)
    edges = {True: [q0, p0, target.grad(q0)], False: [q0, p0, target.grad(q0)]}
    prop, logw, psum = q0, -h0, p0
    alive = torch.ones(c, dtype=torch.bool, device=dev)
    n_leap = torch.zeros(c, dtype=torch.int64, device=dev)
    sum_alpha = torch.zeros_like(h0)
    slots = max(1, depth - 1)
    ck_p = q0.new_zeros((c, slots, d))
    ck_sum = torch.zeros_like(ck_p)
    for k in range(depth):
        if k and not bool(alive.any()):
            break
        right = u_dir[:, k] < 0.5
        r2 = right[:, None]
        signed = torch.where(r2, step, -step)
        q, p, g = (torch.where(r2, a, b) for a, b in zip(edges[True],
                                                         edges[False]))
        s_logw = neg_inf
        s_sum = torch.zeros_like(psum)
        s_turn = torch.zeros_like(alive)
        s_div = torch.zeros_like(alive)
        s_prop = q
        for i in range(1 << k):
            live = alive & ~s_turn & ~s_div
            if i and i % 64 == 0 and not bool(live.any()):
                break
            lv = live[:, None]
            ph = p + 0.5 * signed * g
            qn = q + signed * ph * inv_mass
            gn = target.grad(qn)
            pn = ph + 0.5 * signed * gn
            h = ham(qn, pn)
            delta = h - h0
            nan = torch.isnan(delta)
            div = nan | (delta > max_delta)
            alpha = torch.where(nan, zero, torch.clamp(torch.exp(-delta),
                                                       max=1.0))
            w = torch.where(div, neg_inf, -h)
            s_new = torch.logaddexp(s_logw, w)
            take = live & (log_leaf[:, (1 << k) - 1 + i] < w - s_new)
            s_prop = torch.where(take[:, None], qn, s_prop)
            s_logw = torch.where(live, s_new, s_logw)
            slot = (i >> 1).bit_count()
            if i % 2 == 0:
                keep = (live & ~div)[:, None]
                ck_p[:, slot] = torch.where(keep, pn, ck_p[:, slot])
                ck_sum[:, slot] = torch.where(keep, s_sum, ck_sum[:, slot])
            s_sum = torch.where(lv, s_sum + pn, s_sum)
            if i % 2 == 1:
                lo = slot - _trailing_ones(i) + 1
                span = s_sum[:, None, :] - ck_sum[:, lo:slot + 1]
                turn = (((span * ck_p[:, lo:slot + 1] * inv_mass).sum(-1)
                         <= 0.0)
                        | ((span * (pn * inv_mass)[:, None, :]).sum(-1)
                           <= 0.0)).any(dim=-1)
                s_turn = s_turn | (live & ~div & turn)
            s_div = s_div | (live & div)
            sum_alpha = sum_alpha + torch.where(live, alpha, zero)
            n_leap = n_leap + live.to(torch.int64)
            q, p, g = (torch.where(lv, a, b) for a, b in ((qn, q), (pn, p),
                                                         (gn, g)))
        ok = alive & ~(s_turn | s_div)
        take = ok & (log_merge[:, k] < s_logw - logw)
        prop = torch.where(take[:, None], s_prop, prop)
        logw = torch.where(ok, torch.logaddexp(logw, s_logw), logw)
        okc = ok[:, None]
        psum = torch.where(okc, psum + s_sum, psum)
        for side, mask in ((True, okc & r2), (False, okc & ~r2)):
            edges[side] = [torch.where(mask, a, b)
                           for a, b in zip((q, p, g), edges[side])]
        turned = ok & (((psum * edges[False][1] * inv_mass).sum(-1) <= 0.0)
                       | ((psum * edges[True][1] * inv_mass).sum(-1) <= 0.0))
        alive = ok & ~turned
    accept = sum_alpha / torch.clamp(n_leap.to(dtype), min=1.0)
    return prop, accept, n_leap


def _plan(cell, seed_words):
    """The iterations rebuilt: the first warm-up and the first sampling
    iteration, and ``check_iterations`` more of each run drawn from the
    run's seed."""
    rng = random.Random(seed_words)
    nw, ns, k = cell["n_warmup"], cell["n_sample"], cell["check_iterations"]
    picks = {1, nw + 1}
    picks.update(rng.sample(range(2, nw + 1), min(k, nw - 1)))
    picks.update(rng.sample(range(nw + 2, nw + ns + 1), min(k, ns - 1)))
    return sorted(picks)


def _schedule(job, cell, dtype):
    """Step size and inverse mass of every iteration, worked out from the
    program's acceptance statistics and warm-up positions."""
    args = cell["args"]
    q0 = job["q0"]
    dev = q0.device
    nw = cell["n_warmup"]
    da = DualAveraging(args["step_size"], dtype, dev,
                       target=args.get("target_acceptance_rate", 0.8))
    mv = MovingVariance(q0.shape[1], dtype, dev,
                        collect_iters=args.get("mass_collect_iters", 10))
    steps, inv_mass, step_trace = {}, {}, []
    step = da.step
    accept = torch.cat([job["warm_accept"], job["accept"]]).to(dtype)
    positions = job["warm_samples"]
    for t in range(1, nw + cell["n_sample"] + 1):
        adapt = t <= nw
        if args.get("adapt_mass"):
            if adapt:
                mv.update(q0 if t == 1 else positions[t - 2])
            inv_mass[t] = 1.0 / mv.mass(t)
        else:
            inv_mass[t] = torch.ones(q0.shape[1], dtype=dtype, device=dev)
        steps[t] = step
        step = da.update(accept[t - 1].mean(), adapt, restart=(t == 1))
        step_trace.append(step)
    return steps, inv_mass, torch.stack(step_trace)


def _taken(job, steps):
    """The step the program took at each iteration: the one it collected
    after the iteration before (at the first, the configured one, as in
    ``steps``)."""
    collected = torch.cat([job["warm_step"], job["step"]]).reshape(-1)
    return {t: steps[t] if t == 1 else collected[t - 2] for t in steps}


def _rebuilt(job, t, cell, target, steps, inv_mass, dtype):
    args = cell["args"]
    q = position_before(job, t)
    c, d = q.shape
    draws = noise(job["key"], t, c, d, args["max_tree_depth"], q.device)
    return transition(target, q, inv_mass[t], steps[t],
                      args["max_tree_depth"],
                      args.get("max_delta_energy", 1000.0), draws, dtype)


def check(job, cell, config):
    f64 = torch.float64
    dev = job["q0"].device
    plain = target_of(config)
    std = plain.scale(config).to(dev)
    steps, inv_mass, trace = _schedule(job, cell, f64)
    steps_prog = torch.cat([job["warm_step"], job["step"]])
    out = {"step_size_gap": rel_gap(steps_prog, trace),
           "mass_gap": rel_gap(1.0 / job["mass"].reshape(-1),
                               inv_mass[cell["n_warmup"]])}
    target = plain.density(config, dev, f64)
    taken = _taken(job, steps)
    worst = 0.0
    nw = cell["n_warmup"]
    for t in _plan(cell, job["check_seed"]):
        q, acc, _ = _rebuilt(job, t, cell, target, taken, inv_mass, f64)
        got_acc = (job["warm_accept"][t - 1] if t <= nw
                   else job["accept"][t - 1 - nw])
        worst = max(worst, off_share(draw_of(job, t), q, std, cell["draw_tol"],
                                     got_acc, acc, cell["accept_tol"]))
    out["draws_off"] = worst
    draws = job["samples"]
    out["ess_gap"] = ess_gap(draws, job["ess"], draws.shape[1])
    return out


def stand_in(job, cell, config, dtype):
    """The job with the reference in ``dtype`` put in the program's place
    wherever the check reads it: each chosen iteration rebuilt in ``dtype``
    from the position before it, in order, its draw and acceptance written
    over the program's; the step sizes and the mass worked out in
    ``dtype`` from the acceptance and positions that result; the ESS in
    ``dtype``."""
    dev = job["q0"].device
    target = target_of(config).density(config, dev, dtype)
    rec = dict(job)
    for name in ("warm_samples", "samples", "warm_accept", "accept"):
        rec[name] = job[name].clone()
    nw = cell["n_warmup"]
    for t in _plan(cell, job["check_seed"]):
        steps, inv_mass, _ = _schedule(rec, cell, dtype)
        q, acc, _ = _rebuilt(rec, t, cell, target, steps, inv_mass, dtype)
        draws, accept, i = ((rec["warm_samples"], rec["warm_accept"], t - 1)
                            if t <= nw else
                            (rec["samples"], rec["accept"], t - 1 - nw))
        draws[i], accept[i] = q, acc
    _, inv_mass, trace = _schedule(rec, cell, dtype)
    rec["warm_step"] = trace[:nw].reshape(job["warm_step"].shape)
    rec["step"] = trace[nw:].reshape(job["step"].shape)
    rec["mass"] = (1.0 / inv_mass[nw]).reshape(job["mass"].shape)
    rec["ess"] = ess_total(rec["samples"], rec["samples"].shape[1], dtype)
    return rec
