"""Smoke run of the PyTorch/CUDA port (``zhusuan_tpu_torch``) on one NVIDIA
GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc`` (it builds the kernels from
``zhusuan_tpu_torch/csrc``), imports nothing of JAX, and exits non-zero as
soon as a phase fails (nothing is caught). Each phase prints its seconds.

1. device: the card, as ``nvidia-smi`` reports its name and power limit;
2. build: compiles the fused HMC-step and NUTS kernels, one ``nvcc`` each,
   started together, timing the build and printing ptxas' register and
   spill report;
3. kernel vs plain: the kernel against its plain torch version on the same
   injected noise (the main path's 32768 x 100, 4096 x 100 and a ragged
   1000 x 37, each in float32 and bfloat16), and both timed at
   32768 x 100 (the plain version drawing from torch's generator, as the
   sampler's plain path does, and again with the kernel's Philox);
4. Philox: the kernel's own random numbers (moments over 32768 x 100, the
   same numbers as the plain Philox, reproducible per key);
5. main path: ``bench.py``'s recipe through ``zhusuan_tpu_torch.HMC`` --
   32768 chains x 100 dims, 200 adaptive iterations, then 500 sampling
   iterations with bfloat16 samples, then ``ess_batch_device`` -- on the
   kernel path (3 timed trials) and on the plain path, with the kernel's
   launch count read around the kernel-path run;
6. NUTS kernel vs plain: the fused NUTS transition against its plain torch
   version on the same injected noise, at 4096 x 100 depth 6, 4096 x 100
   depth 10 on the std ``linspace(0.1, 30)`` target (trees reach the cap),
   a ragged 1000 x 37 depth 8, and 4096 x 100 depth 8 at a step past the
   target's stability limit (most chains diverge). Both sides are float32;
   near-ties in a U-turn or multinomial test may change a chain's tree or
   its selected leaf, so the check counts the chains that differ in
   ``(depth, n_leapfrogs, turning, divergent)`` or in q' by more than
   ``NUTS_Q_TOL``, requires at most ``NUTS_MAX_DIFFERING`` (0.1%) of the
   chains to, and compares q', log_prob, energy and accept_stat on the
   rest within ``NUTS_Q_TOL`` / ``NUTS_TOL``. Then both timed at
   4096 x 100, depths 6 and 10;
7. NUTS Philox: the direction, leaf and merge uniforms lie in [0, 1), the
   kernel's own draws give what the plain Philox draws give, and one key
   reproduces bitwise;
8. NUTS main path: ``bench.py``'s ``measure_nuts`` recipe through
   ``zhusuan_tpu_torch.NUTS`` -- 4096 chains x 100 dims, depth 6, 200
   adaptive then 200 sampling iterations collecting samples and leapfrog
   counts, 3 timed trials -- on the kernel path and the plain path, with
   the kernel's launch count read around each;
9. NUTS deep trees: ``bench.py``'s sweep on the ``linspace(0.1, 30)``
   target, kernel path at depths 6, 8 and 10 (150 adaptive, 50 sampling
   iterations, 2 trials), and a few timed plain-path iterations at 10.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

DIM = 100
N_CHAINS = 32768
N_ADAPT = 200
N_ITERS = 500
N_TRIALS = 3
TOL = 1e-4
NUTS_CHAINS = 4096
NUTS_ITERS = 200
NUTS_TOL = (1e-4, 1e-5)  # (abs, rel) on log_prob, energy; abs on accept
NUTS_Q_TOL = 1e-5  # the leapfrog arithmetic is the same on both sides
NUTS_MAX_DIFFERING = 0.001  # share of chains


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase_device(torch):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi reported no GPU")
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    print("phase1 device " + json.dumps(info))
    print(out[0])
    return out[0]


def phase_build():
    from zhusuan_tpu_torch.ops._build import build_libraries

    libs = build_libraries(["hmc_step", "nuts_step"])
    for name, (_, record) in libs.items():
        ptxas = [ln.strip() for ln in record["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print("phase2 build " + json.dumps({
            "kernel": name,
            "seconds": round(record["build_seconds"], 3),
            "library": os.path.relpath(record["path"]),
            "ptxas": ptxas}))


def _problem(torch, dev, c, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    from zhusuan_tpu_torch.ops import DiagonalGaussianLogJoint

    dens = DiagonalGaussianLogJoint(
        "x", 0.1 * randn(d), torch.linspace(0.1, 1.0, d, device=dev))
    q = (dens.loc + dens.scale * randn(c, d)).to(dtype)  # typical set
    mass = 0.5 + 1.5 * torch.rand(1, d, generator=g, device=dev)
    noise = (randn(c, d), torch.rand(c, generator=g, device=dev))
    return q, mass, dens, noise


def _time_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernel_vs_plain(torch, dev):
    from zhusuan_tpu_torch.mcmc.hmc import HMC
    from zhusuan_tpu_torch.ops.hmc_step import (
        fused_hmc_step, fused_hmc_step_reference,
    )

    names = ("q'", "p0", "acc", "old_lp", "new_lp", "old_h", "new_h")
    max_err, cases = 0.0, []
    for c, d in ((N_CHAINS, DIM), (4096, 100), (1000, 37)):
        for dtype in (torch.float32, torch.bfloat16):
            q, mass, dens, noise = _problem(torch, dev, c, d, dtype, c + d)
            step = 0.15  # accepts ~70% of the chains: both decisions
            got = fused_hmc_step(dens, q, mass, step, 5, (1, 2), 1,
                                 noise=noise)
            torch.cuda.synchronize()
            want = fused_hmc_step_reference(dens, q, mass, step, 5, (1, 2), 1,
                                            noise=noise)
            u = noise[1]
            take_k, take_r = u < got[2], u < want[2]
            near = (u - want[2]).abs() < TOL
            check(bool(((take_k == take_r) | near).all()),
                  "accept decisions differ away from |u - acc| < 1e-4 "
                  "at {}x{} {}".format(c, d, dtype))
            agree = take_k == take_r
            errs = {}
            for name, g, w in zip(names, got, want):
                rows = agree if name in ("q'", "new_lp") else \
                    torch.ones_like(agree)
                g, w = g[rows].float(), w[rows].float()
                err = (g - w).abs()
                # bf16 q' is rounded from float32 on both sides: allow one
                # bf16 ulp (at most 2^-7 relative) where the float32 values
                # straddle a rounding boundary.
                rel = 2.0 ** -7 if name == "q'" and dtype == torch.bfloat16 \
                    else TOL
                ok = bool((err <= TOL + rel * w.abs()).all())
                check(ok, "{} differs at {}x{} {}: max abs err {}".format(
                    name, c, d, dtype, float(err.max())))
                errs[name] = float(err.max())
                max_err = max(max_err, errs[name])
            cases.append({"shape": [c, d], "dtype": str(dtype),
                          "accept_rate": float(take_k.float().mean()),
                          "decisions_differing": int((~agree).sum()),
                          "max_abs_err": errs})

    # experimental_fused_step=True on an ineligible CUDA input raises.
    hmc = HMC(step_size=0.1, n_leapfrogs=3, experimental_fused_step=True)
    st = hmc.init({"x": torch.zeros(16, 4, device=dev)}, n_chain_dims=1)
    try:
        hmc.sample(lambda obs: -0.5 * (obs["x"] ** 2).sum(-1), {}, st, (1, 2))
        raised = False
    except ValueError:
        raised = True
    check(raised, "experimental_fused_step=True did not raise on an "
                  "ineligible CUDA input")

    # Times at the main path's shape. The kernel draws its own Philox; the
    # plain version draws from torch's generator (the sampler's plain path)
    # and, separately, through the torch Philox that reproduces the
    # kernel's bits (a few hundred more small integer ops).
    q, mass, dens, _ = _problem(torch, dev, N_CHAINS, DIM, torch.float32, 7)
    step = torch.full((), 0.15, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def plain():
        noise = (torch.randn(N_CHAINS, DIM, generator=gen, device=dev),
                 torch.rand(N_CHAINS, generator=gen, device=dev))
        return fused_hmc_step_reference(dens, q, mass, step, 5, None, 1,
                                        noise=noise)

    ms = _time_ms(torch, lambda: fused_hmc_step(
        dens, q, mass, step, 5, (3, 4), 1), 200)
    plain_ms = _time_ms(torch, plain, 20)
    plain_philox_ms = _time_ms(torch, lambda: fused_hmc_step_reference(
        dens, q, mass, step, 5, (3, 4), 1), 20)
    print("phase3 kernel_vs_plain " + json.dumps({
        "cases": cases, "fused_true_raises_on_ineligible": raised,
        "timing_shape": [N_CHAINS, DIM], "kernel_ms": ms,
        "plain_ms": plain_ms, "plain_philox_ms": plain_philox_ms}))
    return max_err, ms, plain_ms


def phase_philox(torch, dev):
    from zhusuan_tpu_torch.ops._random import (
        STREAM_MH, STREAM_MOMENTUM, philox_normal, philox_uniform,
    )
    from zhusuan_tpu_torch.ops.hmc_step import fused_hmc_step

    q, mass, dens, _ = _problem(torch, dev, N_CHAINS, DIM, torch.float32, 11)
    key, t = (2024, 7), 3
    out = fused_hmc_step(dens, q, mass, 0.05, 5, key, t)
    z = (out[1] / torch.sqrt(mass)).double()
    mean, std = float(z.mean()), float(z.std())
    check(abs(mean) < 0.005 and abs(std - 1.0) < 0.005,
          "p0/sqrt(m) moments off: mean {} std {}".format(mean, std))
    eps = philox_normal(key, t, (N_CHAINS, DIM), STREAM_MOMENTUM, dev)
    p_err = float((out[1] - eps * torch.sqrt(mass)).abs().max())
    check(p_err < TOL, "kernel momentum differs from the plain Philox "
                       "draws by {}".format(p_err))
    u = philox_uniform(key, t, (N_CHAINS,), STREAM_MH, dev)
    check(bool((u >= 0).all() and (u < 1).all()), "uniforms outside [0, 1)")
    moved = (out[0] != q).any(dim=1)
    same = (moved == (u < out[2])) | ((u - out[2]).abs() < 1e-6)
    check(bool(same.all()), "kernel accept decisions disagree with the "
                            "plain Philox uniforms")
    again = fused_hmc_step(dens, q, mass, 0.05, 5, key, t)
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "one key did not reproduce bitwise")
    other = fused_hmc_step(dens, q, mass, 0.05, 5, (2025, 7), t)
    check(not torch.equal(other[1], out[1]), "two keys gave one stream")
    print("phase4 philox " + json.dumps({
        "p0_over_sqrt_m_mean": mean, "p0_over_sqrt_m_std": std,
        "max_abs_err_vs_plain_philox": p_err,
        "uniform_min": float(u.min()), "uniform_max": float(u.max()),
        "reproducible": True, "keys_differ": True}))


def _pooled_std(torch, samples):
    """Per-dim std over (iterations, chains) of a [T, C, D] bf16 tensor,
    in float64, a few iterations at a time."""
    s1 = s2 = 0.0
    n = samples.shape[0] * samples.shape[1]
    for start in range(0, samples.shape[0], 50):
        x = samples[start:start + 50].double()
        s1 = s1 + x.sum(dim=(0, 1))
        s2 = s2 + (x * x).sum(dim=(0, 1))
    mean = s1 / n
    return torch.sqrt(s2 / n - mean * mean)


def _total_ess(samples):
    from zhusuan_tpu_torch.diagnostics import ess_batch_device

    t, c, d = samples.shape
    ess = ess_batch_device(samples.reshape(t, c * d)).reshape(c, d)
    return float(ess.min(dim=1).values.sum())


def run_main_path(torch, dev, fused):
    """bench.py's recipe through the port: warm-up, then N_TRIALS timed
    sampling runs from the warm state with distinct keys."""
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu_torch.ops.hmc_step import fused_hmc_step

    target_std = torch.linspace(0.1, 1.0, DIM, device=dev)
    dens = zt.DiagonalGaussianLogJoint(
        "x", torch.zeros(DIM, device=dev), target_std)
    hmc = zt.HMC(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
                 adapt_mass=True, mass_collect_iters=50,
                 experimental_fused_step="auto" if fused else False)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def sample(state, seed, **kw):
        kw.setdefault("collect_fields", ("samples",))
        kw.setdefault("collect_dtype", torch.bfloat16)
        return hmc.run(dens, {}, state, gen(seed), kw.pop("n", N_ITERS),
                       n_adapt=0, **kw)

    fused_hmc_step.launches = 0
    state = hmc.init({"x": torch.zeros(N_CHAINS, DIM, device=dev)},
                     log_joint=dens)
    state, _ = hmc.run(dens, {}, state, gen(0), N_ADAPT, n_adapt=N_ADAPT,
                       collect=False)
    torch.cuda.synchronize()
    warm_launches = fused_hmc_step.launches
    _, out = sample(state, 1)  # warm-up of the sampling run
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats()
    eps_trials, dt_trials, per_trial_launches = [], [], []
    for trial in range(N_TRIALS):
        before = fused_hmc_step.launches
        t0 = time.perf_counter()
        _, out = sample(state, 2 + trial)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_trial_launches.append(fused_hmc_step.launches - before)
        samples = out["samples"]["x"]
        eps_trials.append(_total_ess(samples) / dt)
        dt_trials.append(dt)
        if trial < N_TRIALS - 1:
            del out, samples
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    std = _pooled_std(torch, samples)
    del out, samples
    _, acc_out = sample(state, 9, n=50, collect_fields=("acceptance_rate",))
    total_launches = fused_hmc_step.launches
    acceptance = float(acc_out["acceptance_rate"].mean())
    rel = float((std / target_std - 1.0).abs().max())
    return {
        "path": "kernel" if fused else "plain",
        "n_chains": N_CHAINS, "dim": DIM, "n_adapt": N_ADAPT,
        "n_iters": N_ITERS, "warmup_launches": warm_launches,
        "sample_launches_per_trial": per_trial_launches,
        "launches": total_launches,
        "step_size": float(state.step_size),
        "mean_acceptance": acceptance,
        "max_rel_std_err": rel,
        "sample_sec_trials": dt_trials,
        "ess_per_sec_trials": eps_trials,
        "ess_per_sec_median": statistics.median(eps_trials),
        "peak_alloc_gb_sampling": peak_gb,
    }


def phase_main_path(torch, dev):
    kernel = run_main_path(torch, dev, fused=True)
    check(kernel["warmup_launches"] == N_ADAPT,
          "warm-up launched the kernel {} times, not {}".format(
              kernel["warmup_launches"], N_ADAPT))
    check(all(n == N_ITERS for n in kernel["sample_launches_per_trial"]),
          "a sampling run did not launch the kernel {} times: {}".format(
              N_ITERS, kernel["sample_launches_per_trial"]))
    plain = run_main_path(torch, dev, fused=False)
    check(plain["launches"] == 0, "the plain path launched the kernel")
    for rec in (kernel, plain):
        check(rec["max_rel_std_err"] < 0.1,
              "{} path: pooled std off by {:.3f}".format(
                  rec["path"], rec["max_rel_std_err"]))
        check(0.6 <= rec["mean_acceptance"] <= 0.95,
              "{} path: mean acceptance {:.3f}".format(
                  rec["path"], rec["mean_acceptance"]))
    print("phase5 main_path " + json.dumps({"kernel": kernel,
                                            "plain": plain}))
    return kernel["launches"]


def _nuts_problem(torch, dev, c, d, std_max, seed, unit_mass=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    from zhusuan_tpu_torch.ops import DiagonalGaussianLogJoint

    dens = DiagonalGaussianLogJoint(
        "x", 0.1 * torch.randn(d, generator=g, device=dev),
        torch.linspace(0.1, std_max, d, device=dev))
    q = dens.loc + dens.scale * torch.randn(c, d, generator=g, device=dev)
    inv_mass = (torch.ones(1, d, device=dev) if unit_mass else
                0.5 + 1.5 * torch.rand(1, d, generator=g, device=dev))
    return dens, q, inv_mass


def _compare_nuts(torch, got, want):
    """Chains differing in the tree or the selected leaf, and the largest
    errors on the others (see the module docstring)."""
    c = got[0].shape[0]
    same_tree = ((got[4] == want[4]) & (got[5] == want[5])
                 & (got[6] == want[6]) & (got[7] == want[7]))
    q_err = (got[0] - want[0]).abs().amax(dim=1)
    same = same_tree & (q_err <= NUTS_Q_TOL * (1.0 + want[0].abs().amax(1)))
    n_diff = int((~same).sum())
    check(n_diff <= NUTS_MAX_DIFFERING * c,
          "{} of {} chains differ between the NUTS kernel and its plain "
          "version (at most {} allowed)".format(n_diff, c,
                                                NUTS_MAX_DIFFERING * c))
    errs = {"q'": float(q_err[same].max())}
    for name, g, w in zip(("log_prob", "energy", "accept_stat"), got[1:4],
                          want[1:4]):
        g, w = g[same], w[same]
        err = (g - w).abs()
        tol = NUTS_TOL[0] + (NUTS_TOL[1] * w.abs() if name != "accept_stat"
                             else 0.0)
        check(bool((err <= tol).all()), "NUTS {} differs by {}".format(
            name, float(err.max())))
        errs[name] = float(err.max())
    return {"tree_differing": int((~same_tree).sum()),
            "selection_differing": int((same_tree & ~same).sum()),
            "max_abs_err": errs}


def phase_nuts_kernel_vs_plain(torch, dev):
    from zhusuan_tpu_torch.mcmc.nuts import NUTS, draw_noise
    from zhusuan_tpu_torch.ops.nuts_step import (
        fused_nuts_transition, fused_nuts_transition_reference,
    )

    cases, max_err = [], 0.0
    # (chains, dim, depth, std max, step, unit mass): the main path's
    # depth 6; depth 10 where trees reach the cap; a ragged shape; a step
    # just past the stability limit of the std-0.1 coordinate (0.2 at unit
    # mass), where most chains diverge and the rest turn.
    for c, d, depth, std_max, step, unit in (
            (NUTS_CHAINS, DIM, 6, 1.0, 0.1, False),
            (NUTS_CHAINS, DIM, 10, 30.0, 0.1, False),
            (1000, 37, 8, 1.0, 0.2, False),
            (NUTS_CHAINS, DIM, 8, 1.0, 0.203, True)):
        dens, q, inv_mass = _nuts_problem(torch, dev, c, d, std_max,
                                          c + d + depth, unit)
        noise = draw_noise(torch.Generator(device=dev).manual_seed(depth),
                           c, d, depth, torch.float32, dev)
        got = fused_nuts_transition(dens, q, inv_mass, step, depth, 1000.0,
                                    (1, 2), 1, noise=noise)
        torch.cuda.synchronize()
        want = fused_nuts_transition_reference(
            dens, q, inv_mass, step, depth, 1000.0, (1, 2), 1, noise=noise)
        rec = _compare_nuts(torch, got, want)
        rec.update({"shape": [c, d], "depth": depth, "step": step,
                    "mean_depth": float(want[4].float().mean()),
                    "divergent": float(want[7].float().mean()),
                    "turning": float(want[6].float().mean())})
        max_err = max([max_err] + list(rec["max_abs_err"].values()))
        cases.append(rec)
    check(cases[1]["mean_depth"] > 6, "depth-10 case: trees stayed shallow")
    check(0.0 < cases[3]["divergent"] < 1.0,
          "divergent case: {} of the chains diverged".format(
              cases[3]["divergent"]))

    # experimental_fused_step=True on an ineligible CUDA input raises.
    nuts = NUTS(step_size=0.1, max_tree_depth=4, experimental_fused_step=True)
    st = nuts.init({"x": torch.zeros(16, 4, device=dev)}, n_chain_dims=1)
    try:
        nuts.sample(lambda obs: -0.5 * (obs["x"] ** 2).sum(-1), {}, st, (1, 2))
        raised = False
    except ValueError:
        raised = True
    check(raised, "NUTS experimental_fused_step=True did not raise on an "
                  "ineligible CUDA input")

    # Times at the main path's width: the kernel with its own Philox; the
    # plain version drawing from torch's generator (the sampler's plain
    # path) and, at depth 6, through the torch Philox.
    timing = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for depth, std_max in ((6, 1.0), (10, 30.0)):
        dens, q, inv_mass = _nuts_problem(torch, dev, NUTS_CHAINS, DIM,
                                          std_max, 7)
        ms = _time_ms(torch, lambda: fused_nuts_transition(
            dens, q, inv_mass, 0.1, depth, 1000.0, (3, 4), 1), 50)

        def plain():
            noise = draw_noise(gen, NUTS_CHAINS, DIM, depth, torch.float32,
                               dev)
            return fused_nuts_transition_reference(
                dens, q, inv_mass, 0.1, depth, 1000.0, None, 1, noise=noise)

        plain_ms = _time_ms(torch, plain, 5 if depth == 6 else 2)
        timing["depth%d" % depth] = {"kernel_ms": ms, "plain_ms": plain_ms}
        if depth == 6:
            timing["depth6"]["plain_philox_ms"] = _time_ms(
                torch, lambda: fused_nuts_transition_reference(
                    dens, q, inv_mass, 0.1, depth, 1000.0, (3, 4), 1), 5)
    print("phase6 nuts_kernel_vs_plain " + json.dumps({
        "cases": cases, "fused_true_raises_on_ineligible": raised,
        "timing_shape": [NUTS_CHAINS, DIM], "timing": timing}))
    return max_err, timing


def phase_nuts_philox(torch, dev):
    from zhusuan_tpu_torch.ops._random import (
        STREAM_NUTS_DIRECTION, STREAM_NUTS_LEAF, STREAM_NUTS_MERGE,
        philox_uniform_rows,
    )
    from zhusuan_tpu_torch.ops.nuts_step import (
        fused_nuts_transition, nuts_noise,
    )

    key, t, depth = (2024, 7), 3, 10
    ranges = {}
    for name, stream, cols in (("direction", STREAM_NUTS_DIRECTION, depth),
                               ("leaf", STREAM_NUTS_LEAF, (1 << depth) - 1),
                               ("merge", STREAM_NUTS_MERGE, depth)):
        u = philox_uniform_rows(key, t, (NUTS_CHAINS, cols), stream, dev)
        lo, hi = float(u.min()), float(u.max())
        check(0.0 <= lo and hi < 1.0, "{} uniforms outside [0, 1)".format(
            name))
        ranges[name] = {"min": lo, "max": hi,
                        "mean": float(u.double().mean())}
    dens, q, inv_mass = _nuts_problem(torch, dev, NUTS_CHAINS, DIM, 30.0, 11)
    own = fused_nuts_transition(dens, q, inv_mass, 0.1, depth, 1000.0, key, t)
    drawn = fused_nuts_transition(
        dens, q, inv_mass, 0.1, depth, 1000.0, key, t,
        noise=nuts_noise(key, t, NUTS_CHAINS, DIM, depth, dev))
    check(all(torch.equal(a, b) for a, b in zip(own, drawn)),
          "the NUTS kernel's own draws differ from the plain Philox draws")
    again = fused_nuts_transition(dens, q, inv_mass, 0.1, depth, 1000.0,
                                  key, t)
    check(all(torch.equal(a, b) for a, b in zip(own, again)),
          "one key did not reproduce the NUTS kernel bitwise")
    other = fused_nuts_transition(dens, q, inv_mass, 0.1, depth, 1000.0,
                                  (2025, 7), t)
    check(not torch.equal(other[0], own[0]), "two keys gave one stream")
    print("phase7 nuts_philox " + json.dumps({
        "uniforms": ranges, "kernel_draws_equal_plain_philox": True,
        "reproducible": True, "keys_differ": True}))


def _nuts_run(torch, dev, fused, depth, std_max, n_adapt, n_iters, trials,
              fields=("samples", "n_leapfrogs")):
    """bench.py's measure_nuts recipe through the port: warm-up, one
    untimed sampling run, then ``trials`` timed sampling runs from the warm
    state with distinct keys. Returns the record and the kernel launches
    of each part."""
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu_torch.ops.nuts_step import fused_nuts_transition

    target_std = torch.linspace(0.1, std_max, DIM, device=dev)
    dens = zt.DiagonalGaussianLogJoint(
        "x", torch.zeros(DIM, device=dev), target_std)
    nuts = zt.NUTS(step_size=0.1, max_tree_depth=depth, adapt_step_size=True,
                   experimental_fused_step="auto" if fused else False)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    launches = []

    def counted(fn):
        before = fused_nuts_transition.launches
        out = fn()
        torch.cuda.synchronize()
        launches.append(fused_nuts_transition.launches - before)
        return out

    state = nuts.init({"x": torch.zeros(NUTS_CHAINS, DIM, device=dev)},
                      log_joint=dens)
    state, _ = counted(lambda: nuts.run(dens, {}, state, gen(41), n_adapt,
                                        n_adapt=n_adapt, collect=False))
    if trials > 1:  # untimed: the first sampling run
        counted(lambda: nuts.run(dens, {}, state, gen(42), n_iters,
                                 collect_fields=fields))
    dts = []
    for trial in range(trials):
        t0 = time.perf_counter()
        _, out = counted(lambda: nuts.run(dens, {}, state, gen(43 + trial),
                                          n_iters, collect_fields=fields))
        dts.append(time.perf_counter() - t0)
    ci = NUTS_CHAINS * n_iters / min(dts)
    leaps = float(out["n_leapfrogs"].float().mean())
    rec = {
        "path": "kernel" if fused else "plain", "max_tree_depth": depth,
        "n_chains": NUTS_CHAINS, "dim": DIM, "n_adapt": n_adapt,
        "n_iters": n_iters, "step_size": float(state.step_size),
        "chain_iters_per_sec_M": ci / 1e6,
        "leapfrog_chain_steps_per_sec_M": ci * leaps / 1e6,
        "mean_leapfrogs": leaps,
        "sample_sec_trials": dts,
        "launches_per_run": launches,
    }
    if "depth" in out:
        rec["mean_depth"] = float(out["depth"].float().mean())
    if "samples" in out:
        std = _pooled_std(torch, out["samples"]["x"])
        rec["max_rel_std_err"] = float((std / target_std - 1.0).abs().max())
    return rec


def phase_nuts_main_path(torch, dev):
    from zhusuan_tpu_torch.ops.nuts_step import fused_nuts_transition

    runs = {}
    for fused in (True, False):
        fused_nuts_transition.launches = 0
        rec = _nuts_run(torch, dev, fused, 6, 1.0, NUTS_ITERS, NUTS_ITERS,
                        N_TRIALS)
        rec["launches"] = fused_nuts_transition.launches
        runs[rec["path"]] = rec
    kernel, plain = runs["kernel"], runs["plain"]
    want = [NUTS_ITERS] * (N_TRIALS + 2)
    check(kernel["launches_per_run"] == want,
          "the NUTS kernel path launched {} times per run, not one per "
          "iteration {}".format(kernel["launches_per_run"], want))
    check(kernel["launches"] == sum(want), "NUTS launch count off")
    check(plain["launches"] == 0, "the NUTS plain path launched the kernel")
    for rec in (kernel, plain):
        check(rec["max_rel_std_err"] < 0.1,
              "NUTS {} path: pooled std off by {:.3f}".format(
                  rec["path"], rec["max_rel_std_err"]))
    print("phase8 nuts_main_path " + json.dumps(runs))
    return kernel["launches"]


def phase_nuts_deep(torch, dev):
    from zhusuan_tpu_torch.ops.nuts_step import fused_nuts_transition

    fields = ("samples", "n_leapfrogs", "depth")
    deep = {"target": "diag Gaussian stds 0.1..30 (trees reach the cap)"}
    for depth in (6, 8, 10):
        deep["kernel_depth%d" % depth] = _nuts_run(
            torch, dev, True, depth, 30.0, 150, 50, 2, fields)
    check(deep["kernel_depth10"]["mean_depth"] > 6,
          "depth-10 sweep: mean tree depth {} <= 6".format(
              deep["kernel_depth10"]["mean_depth"]))
    # The plain path at depth 10: a short warm-up, then a few timed
    # iterations (a full run would take minutes).
    fused_nuts_transition.launches = 0
    deep["plain_depth10"] = _nuts_run(torch, dev, False, 10, 30.0, 20, 3, 1,
                                      ("n_leapfrogs", "depth"))
    check(fused_nuts_transition.launches == 0,
          "the NUTS plain path launched the kernel")
    k, p = deep["kernel_depth10"], deep["plain_depth10"]
    deep["kernel_over_plain_depth10"] = (k["chain_iters_per_sec_M"]
                                         / p["chain_iters_per_sec_M"])
    print("phase9 nuts_deep " + json.dumps(deep))


def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print("{} seconds {:.3f}".format(name, time.perf_counter() - t0),
          flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device.")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import zhusuan_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run_phase("phase1", phase_device, torch)
    run_phase("phase2", phase_build)
    max_err, ms, plain_ms = run_phase("phase3", phase_kernel_vs_plain, torch,
                                      dev)
    run_phase("phase4", phase_philox, torch, dev)
    launches = run_phase("phase5", phase_main_path, torch, dev)
    nuts_err, nuts_timing = run_phase("phase6", phase_nuts_kernel_vs_plain,
                                      torch, dev)
    run_phase("phase7", phase_nuts_philox, torch, dev)
    nuts_launches = run_phase("phase8", phase_nuts_main_path, torch, dev)
    run_phase("phase9", phase_nuts_deep, torch, dev)
    print(json.dumps({"kernels": [{
        "name": "fused_hmc_step",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/hmc_step.cu",
        "replaces": "zhusuan_tpu/ops/hmc_step.py:206",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "fused_nuts_transition",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/nuts_step.cu",
        "replaces": ["zhusuan_tpu/ops/nuts_step.py:331",
                     "zhusuan_tpu/ops/nuts_step.py:641"],
        "launches": nuts_launches,
        "max_abs_err": nuts_err,
        "ms": nuts_timing["depth6"]["kernel_ms"],
        "plain_ms": nuts_timing["depth6"]["plain_ms"],
        "ms_depth10": nuts_timing["depth10"]["kernel_ms"],
        "plain_ms_depth10": nuts_timing["depth10"]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
