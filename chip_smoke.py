"""Smoke run of the PyTorch/CUDA port (``zhusuan_tpu_torch``) on one NVIDIA
GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc`` (it builds the kernels from
``zhusuan_tpu_torch/csrc``), imports nothing of JAX, and exits non-zero as
soon as a phase fails (nothing is caught). Each phase prints its seconds.

1. device: the card, as ``nvidia-smi`` reports its name and power limit;
2. build: compiles ``csrc/hmc_step.cu`` (the HMC step, ChEES step and
   trajectory kernels), ``csrc/nuts_step.cu`` and ``csrc/sgmcmc_step.cu``
   (the SGLD, PSGLD, SGHMC and SGNHT kernels), one ``nvcc`` each, started
   together, timing the build and printing ptxas' register and spill
   report;
3. kernel vs plain: the HMC step kernel (diagonal density) against its
   plain torch version on the same
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
   iterations, 2 trials), and a few timed plain-path iterations at 10;
10. HMC family vs plain: the HMC step with the equicorrelated density, the
   ChEES step and the leapfrog trajectory against their plain torch
   versions on the same injected noise, float32, at 4096 x 100 (the mixing
   width) and a ragged 1000 x 37, for both built-in densities: the ChEES
   step at counts 1, 37, 190 and ``CHEES_MAX_LEAPFROGS``, and at 190 with a
   step past the stability limit (every chain diverges); the trajectory
   with a ``[1, dim]`` and a ``[chains, dim]`` mass. A sum's order differs
   between the kernel and torch, so a chain may take the other MH decision
   at a near-tie: at most ``MAX_DIFFERING`` (0.1%) of the chains may differ
   in the decision (or in whether the proposal is finite); on the rest
   q', p' within ``Q_TOL`` relative to ``1 + |ref|`` and log-probs and
   energies within ``LP_TOL``. Then each timed against its plain version at
   4096 x 100 (the ChEES step at 100 and 190 leapfrogs);
11. mixing: ``bench.py``'s ``measure_mixing`` through the port, 4096 chains
   x 100 dims of the equicorrelated Gaussian (rho 0.95), 300 adaptive then
   3 timed runs of 300 sampling iterations per arm: (a) fixed-L HMC with
   step-size and mass adaptation (the HMC step kernel), (a') the same with
   ``experimental_fused_step=False, experimental_fused_leapfrog=True`` (the
   trajectory kernel), (b) ChEES (the ChEES kernel), (c) pilot ->
   ``fit_dense_preconditioner`` -> ``whiten_log_joint`` -> HMC (a plain
   callable: the plain path, 0 launches); (a) and (b) again on the plain
   path (one timed run). Each reports min-coordinate and slow-projection
   ESS and their rates; gated on finite samples, on acceptance (whitened
   HMC in [0.6, 0.95]; fixed-L in [``FIXED_L_MIN_ACCEPTANCE``, 0.95], as
   the JAX package samples it at ~0.58; ChEES's harmonic mean within 0.1
   of 0.651) and on ChEES's slow-projection ESS above fixed-L's;
12. SGMCMC kernels vs plain: the SGLD, PSGLD, SGHMC (first and second
   order, each on a plain and a momentum-resampling iteration) and SGNHT
   (vector thermostat, first and second order) kernels against their plain
   torch versions, float32, at ``SG_CHAINS`` x 100 and a ragged 1000 x 37,
   for both built-in densities: once on the same Philox draws injected
   into both (every element bit for bit on the diagonal density; the rest
   within ``Q_TOL`` relative to ``1 + |ref|``), once on the kernel's own
   draws against the plain Philox (within ``Q_TOL``). Then each timed
   against its plain version at ``SG_CHAINS`` x 100, beside its bound:
   back to back with CUDA events, and replayed from a CUDA graph (the
   device's time alone, the record's ``ms``);
13. SGMCMC main path: ``zhusuan_tpu_torch.SGLD``, ``PSGLD``, ``SGHMC``
   (second order) and ``SGNHT`` (vector thermostat) through ``init`` and
   ``run`` on ``bench.py``'s target, ``SG_CHAINS`` chains x 100 dims:
   ``SG_WARMUP`` warm-up iterations (``collect=False``), then sampling runs
   of ``SG_ITERS`` iterations keeping every ``SG_THINNING``-th, on the
   kernel path (an untimed run, then 3 timed) and on the plain path (1
   timed); chain-iterations/s and each kernel's launches read around each
   path. Gated on finite samples and on each dimension's variance: SGLD's
   and SGHMC's against their exact values (both updates are linear on a
   Gaussian, so the covariance follows exactly) within ``SG_VAR_TOL``,
   SGNHT's against the JAX package's run of the same recipe
   (``SG_REFERENCE``, from ``scripts/sgmcmc_jax_reference.py``) and
   PSGLD's kernel path against its plain path, within ``SG_REF_TOL``.

Each entry of the kernels' record carries its bound (``bound_ms``: the
larger of the bytes it must move over 3.35 TB/s and the operations it does
over 67 TFLOP/s, counted from the sources by the ``_*_bound`` helpers at
the timed call's shape and, for NUTS, its trees).

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
MIX_CHAINS = 4096
MIX_RHO = 0.95
MIX_ITERS = 300  # adaptive, then sampling iterations per run
CHEES_MAX_LEAPFROGS = 1000  # ChEESHMC's default cap
MAX_DIFFERING = 0.001  # share of chains (MH decision or finiteness)
Q_TOL = 1e-4  # q', p' relative to 1 + |ref|
LP_TOL = (1e-4, 1e-5)  # (abs, rel) on log-probs and energies
# The fixed-L arm's dual-averaged step (exp(log_epsilon_bar)) samples this
# target at ~0.58 mean acceptance in the JAX package too (4096 x 100,
# float32, CPU), below its 0.8 target; the whitened arm samples at 0.80.
FIXED_L_MIN_ACCEPTANCE = 0.5
# Phase 13, the SGMCMC samplers on bench.py's target (diagonal Gaussian,
# std linspace(0.1, 1.0), 100 dims) at the width the JAX package sizes
# their path for (zhusuan_tpu/mcmc/sgmcmc.py:103-104). The std-0.1
# coordinate sets the stability limit: SGLD contracts it by
# 1 - lr / (2 0.1^2) = 0.5 per iteration at lr 0.01.
SG_CHAINS = 32768
SG_WARMUP = 1000  # iterations, collect=False
SG_ITERS = 500  # sampling iterations per run, every SG_THINNING-th kept
SG_THINNING = 10
SG_SAMPLERS = {
    "SGLD": {"learning_rate": 0.01},
    # epsilon 0.1 bounds the preconditioner at 10: with the default 1e-3
    # the std-0.1 coordinate's variance comes out 14-33 times too large.
    "PSGLD": {"learning_rate": 0.01, "epsilon": 0.1},
    # friction 0.25, a momentum resample every 20 iterations, second order.
    "SGHMC": {"learning_rate": 0.01},
    # the vector thermostat, second order; variance_extra 0 would inject
    # no noise at all.
    "SGNHT": {"learning_rate": 0.01, "variance_extra": 0.1},
}
SG_VAR_TOL = 0.03  # SGLD, SGHMC: per-dim variance / its exact value - 1
SG_REF_TOL = 0.05  # SGNHT vs the JAX package; PSGLD kernel vs plain path
SG_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scripts", "sgmcmc_jax_reference.json")


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

    libs = build_libraries(["hmc_step", "nuts_step", "sgmcmc_step"])
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


def _graph_ms(torch, fn, n):
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph and replayed, so that the host's time to enqueue a call
    (which back-to-back calls also time) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _time_ms(torch, graph.replay, 5) / n


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
        # The leapfrogs the timed call's trees take (its bound's work).
        leapfrogs = int(fused_nuts_transition(
            dens, q, inv_mass, 0.1, depth, 1000.0, (3, 4), 1)[5].sum())

        def plain():
            noise = draw_noise(gen, NUTS_CHAINS, DIM, depth, torch.float32,
                               dev)
            return fused_nuts_transition_reference(
                dens, q, inv_mass, 0.1, depth, 1000.0, None, 1, noise=noise)

        plain_ms = _time_ms(torch, plain, 5 if depth == 6 else 2)
        timing["depth%d" % depth] = {
            "kernel_ms": ms, "plain_ms": plain_ms,
            **_nuts_bound(NUTS_CHAINS, DIM, leapfrogs),
            "leapfrogs_total": leapfrogs}
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


def _family_problem(torch, dev, c, d, density, seed, unit_mass=False):
    """A built-in density, positions in its typical set, a mass and the
    injected noise (normals [c, d], uniforms [c])."""
    from zhusuan_tpu_torch.ops import (
        DiagonalGaussianLogJoint, EquicorrelatedGaussianLogJoint,
    )

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    if density == "diagonal":
        dens = DiagonalGaussianLogJoint(
            "x", 0.1 * randn(d), torch.linspace(0.1, 1.0, d, device=dev))
        q = dens.loc + dens.scale * randn(c, d)
    else:
        dens = EquicorrelatedGaussianLogJoint("x", d, MIX_RHO)
        q = MIX_RHO ** 0.5 * randn(c, 1) + (1.0 - MIX_RHO) ** 0.5 * randn(c, d)
    mass = (torch.ones(1, d, device=dev) if unit_mass
            else 0.5 + 1.5 * torch.rand(1, d, generator=g, device=dev))
    noise = (randn(c, d), torch.rand(c, generator=g, device=dev))
    return dens, q, mass, noise


def _hold(torch, label, u, acc, proposal, q_pairs, lp_pairs):
    """Hold a kernel's outputs against its plain version's (see the module
    docstring, phase 10). ``acc`` and ``proposal`` are (kernel, plain)
    pairs or None (no MH test; no proposal); ``q_pairs`` and ``lp_pairs``
    map names to (kernel, plain, decision-dependent)."""
    c = u.shape[0]
    same = (torch.ones_like(u, dtype=torch.bool) if acc is None
            else (u < acc[0]) == (u < acc[1]))
    if proposal is not None:
        same &= (torch.isfinite(proposal[0]).all(1)
                 == torch.isfinite(proposal[1]).all(1))
    n_diff = int((~same).sum())
    check(n_diff <= MAX_DIFFERING * c,
          "{}: {} of {} chains differ in the MH decision or the proposal's "
          "finiteness (at most {} allowed)".format(label, n_diff, c,
                                                  MAX_DIFFERING * c))
    errs = {}
    for name, (g, w, dependent) in q_pairs.items():
        rows = same if dependent else torch.ones_like(same)
        g, w = g[rows].float(), w[rows].float()
        both = torch.isfinite(g) & torch.isfinite(w)
        check(bool((both == torch.isfinite(w)).all()),
              "{}: {} finite on one side only".format(label, name))
        err = (g - w).abs()[both]
        rel = float((err / (1.0 + w.abs()[both])).max()) if err.numel() \
            else 0.0
        check(rel <= Q_TOL, "{}: {} differs by {} relative to 1 + |ref|"
              .format(label, name, rel))
        errs[name] = float(err.max()) if err.numel() else 0.0
    for name, (g, w, dependent) in lp_pairs.items():
        rows = same if dependent else torch.ones_like(same)
        g, w = g[rows].float(), w[rows].float()
        fin = torch.isfinite(w)
        err = (g - w).abs()[fin]
        over = float((err / (LP_TOL[0] + LP_TOL[1] * w.abs()[fin])).max()) \
            if err.numel() else 0.0
        check(over <= 1.0, "{}: {} differs by {} times the tolerance {}"
              .format(label, name, over, LP_TOL))
        errs[name] = float(err.max()) if err.numel() else 0.0
    rec = {"decisions_differing": n_diff, "max_abs_err": errs}
    if acc is not None:
        rec["accept_rate"] = float((u < acc[1]).float().mean())
    return rec


def phase_family_vs_plain(torch, dev):
    from zhusuan_tpu_torch.mcmc import ChEESHMC
    from zhusuan_tpu_torch.ops import (
        fused_chees_step, fused_chees_step_reference, fused_hmc_step,
        fused_hmc_step_reference, fused_leapfrog, fused_leapfrog_reference,
    )

    cases = {"hmc_step": [], "chees_step": [], "leapfrog": []}
    max_err = {k: 0.0 for k in cases}

    def record(kind, rec, **info):
        rec.update(info)
        cases[kind].append(rec)
        max_err[kind] = max([max_err[kind]]
                            + list(rec["max_abs_err"].values()))

    for c, d in ((MIX_CHAINS, DIM), (1000, 37)):
        for density, step in (("equicorrelated", 0.25), ("diagonal", 0.15)):
            # The HMC step (K1), 5 leapfrogs.
            dens, q, mass, noise = _family_problem(torch, dev, c, d, density,
                                                   c + d)
            got = fused_hmc_step(dens, q, mass, step, 5, (1, 2), 1,
                                 noise=noise)
            torch.cuda.synchronize()
            want = fused_hmc_step_reference(dens, q, mass, step, 5, (1, 2), 1,
                                            noise=noise)
            rec = _hold(torch, "hmc_step {} {}x{}".format(density, c, d),
                        noise[1], (got[2], want[2]), None,
                        {"q'": (got[0], want[0], True),
                         "p0": (got[1], want[1], False)},
                        {"acc": (got[2], want[2], False),
                         "old_lp": (got[3], want[3], False),
                         "new_lp": (got[4], want[4], True),
                         "old_h": (got[5], want[5], False),
                         "new_h": (got[6], want[6], False)})
            record("hmc_step", rec, density=density, shape=[c, d], step=step)

            # The trajectory (K2), with both mass shapes.
            p = noise[0]
            for per_chain in (False, True):
                m = (0.5 + 1.5 * torch.rand(c, d, device=dev) if per_chain
                     else mass)
                got = fused_leapfrog(dens, q, p, step, 5, m)
                torch.cuda.synchronize()
                want = fused_leapfrog_reference(dens, q, p, step, 5, m)
                rec = _hold(torch, "leapfrog {} {}x{}".format(density, c, d),
                            noise[1], None, None,
                            {"q'": (got[0], want[0], False),
                             "p'": (got[1], want[1], False)}, {})
                record("leapfrog", rec, density=density, shape=[c, d],
                       step=step, mass="[{}, dim]".format(c if per_chain
                                                          else 1))

            # The ChEES step (K7): unit mass, the device count; the last
            # case is past the stability limit (0.447 for the
            # equicorrelated density's fast directions, 0.2 for the
            # diagonal one's std 0.1), where every chain diverges.
            dens, q, mass, noise = _family_problem(torch, dev, c, d, density,
                                                   c + d + 1, unit_mass=True)
            eps = 0.2 if density == "equicorrelated" else 0.15
            past = 0.5 if density == "equicorrelated" else 0.25
            for n, ss in ((1, eps), (37, eps), (190, eps),
                          (CHEES_MAX_LEAPFROGS, eps), (190, past)):
                n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
                got = fused_chees_step(dens, q, mass, ss, n_dev, (1, 2), 1,
                                       noise=noise)
                torch.cuda.synchronize()
                want = fused_chees_step_reference(dens, q, mass, ss, n_dev,
                                                  (1, 2), 1, noise=noise)
                label = "chees_step {} {}x{} n={} step={}".format(
                    density, c, d, n, ss)
                rec = _hold(torch, label, noise[1], (got[3], want[3]),
                            (got[1], want[1]),
                            {"q'": (got[0], want[0], True),
                             "prop_q": (got[1], want[1], True),
                             "prop_p": (got[2], want[2], True)},
                            {"acc": (got[3], want[3], True),
                             "old_lp": (got[4], want[4], False),
                             "sel_lp": (got[5], want[5], True)})
                rec["divergent"] = float(
                    (~torch.isfinite(want[1]).all(1)).float().mean())
                record("chees_step", rec, density=density, shape=[c, d],
                       n_leapfrogs=n, step=ss)
            check(cases["chees_step"][-1]["divergent"] > 0.5,
                  "the ChEES step past the stability limit: only {} of the "
                  "chains diverged".format(cases["chees_step"][-1][
                      "divergent"]))

    # ChEESHMC(experimental_fused_step=True) on an ineligible CUDA input
    # raises.
    ch = ChEESHMC(step_size=0.1, experimental_fused_step=True)
    st = ch.init({"z": torch.zeros(16, 4, device=dev)})
    try:
        ch.sample(lambda obs: -0.5 * (obs["z"] ** 2).sum(-1), {}, st, (1, 2))
        raised = False
    except ValueError:
        raised = True
    check(raised, "ChEES experimental_fused_step=True did not raise on an "
                  "ineligible CUDA input")

    # Times at the mixing width: each kernel with its own Philox; its plain
    # version with torch's generator, as the samplers' plain paths draw.
    timing = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    dens, q, mass, _ = _family_problem(torch, dev, MIX_CHAINS, DIM,
                                       "equicorrelated", 7)
    step = torch.full((), 0.2, device=dev)

    def draws():
        return (torch.randn(MIX_CHAINS, DIM, generator=gen, device=dev),
                torch.rand(MIX_CHAINS, generator=gen, device=dev))

    timing["hmc_step_equicorrelated_n5"] = {
        "kernel_ms": _time_ms(torch, lambda: fused_hmc_step(
            dens, q, mass, step, 5, (3, 4), 1), 200),
        "plain_ms": _time_ms(torch, lambda: fused_hmc_step_reference(
            dens, q, mass, step, 5, None, 1, noise=draws()), 20)}
    p = draws()[0]
    timing["leapfrog_equicorrelated_n5"] = {
        "kernel_ms": _time_ms(torch, lambda: fused_leapfrog(
            dens, q, p, step, 5, mass), 200),
        "plain_ms": _time_ms(torch, lambda: fused_leapfrog_reference(
            dens, q, p, step, 5, mass), 20)}
    ones = torch.ones(1, DIM, device=dev)
    for n in (100, 190):
        n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
        timing["chees_step_equicorrelated_n%d" % n] = {
            "kernel_ms": _time_ms(torch, lambda: fused_chees_step(
                dens, q, ones, step, n_dev, (3, 4), 1), 50),
            "plain_ms": _time_ms(torch, lambda: fused_chees_step_reference(
                dens, q, ones, step, n_dev, None, 1, noise=draws()), 3)}
    print("phase10 family_vs_plain " + json.dumps({
        "cases": cases, "chees_fused_true_raises_on_ineligible": raised,
        "timing_shape": [MIX_CHAINS, DIM], "timing": timing}))
    return max_err, timing


def _slow_sd():
    """std of sum(z) under the equicorrelated target (bench.py:316)."""
    return (DIM * (1.0 + (DIM - 1) * MIX_RHO)) ** 0.5


def _mixing_ess(torch, traj):
    """(sum over chains of the min-coordinate ESS, sum over chains of the
    slow projection sum(z) / sd's ESS) of a [T, C, D] trajectory
    (bench.py:318-332)."""
    from zhusuan_tpu_torch.diagnostics import ess_batch_device

    t, c, d = traj.shape
    traj = traj.float()
    ess = ess_batch_device(traj.reshape(t, c * d)).reshape(c, d)
    coord = float(ess.min(dim=1).values.sum())
    slow = ess_batch_device(traj.sum(dim=-1) / _slow_sd())
    return coord, float(slow.sum())


def _timed_trials(torch, sample, trials, postmap=None, launch_fns=()):
    """bench.py's timed_trials: an untimed sampling run, then ``trials``
    timed runs from the same warm state with distinct keys; the trial with
    the median slow-projection ESS/s is reported, with every trial's
    numbers and the kernels' launches per run."""
    sample(100)
    torch.cuda.synchronize()
    rows = []
    for trial in range(trials):
        before = [f.launches for f in launch_fns]
        t0 = time.perf_counter()
        out = sample(101 + trial)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        traj = out["samples"]["z"]
        if postmap is not None:
            traj = postmap(traj)
        check(bool(torch.isfinite(traj).all()), "non-finite samples")
        coord, slow = _mixing_ess(torch, traj)
        rows.append({"sample_sec": dt, "min_coord_ess": coord,
                     "slow_proj_ess": slow, "ess_per_sec": coord / dt,
                     "slow_proj_ess_per_sec": slow / dt,
                     "out": out, "traj": traj,
                     "launches": [f.launches - b
                                  for f, b in zip(launch_fns, before)]})
    order = sorted(range(trials),
                   key=lambda i: rows[i]["slow_proj_ess_per_sec"])
    mid = rows[order[trials // 2]]
    rec = {k: v for k, v in mid.items() if k not in ("out", "traj")}
    rec["trials_slow_proj_ess_per_sec"] = [r["slow_proj_ess_per_sec"]
                                           for r in rows]
    rec["trials_launches"] = [r["launches"] for r in rows]
    return rec, mid["out"], mid["traj"]


def _acceptance(out):
    acc = out["acceptance_rate"].double()
    return float(acc.mean()), float(
        (1.0 / (1.0 / acc.clamp(min=1e-10)).mean(dim=1)).mean())


def _mixing_hmc(torch, dev, fused, leapfrog_kernel, trials):
    """Arm (a): fixed-L HMC with step-size and mass adaptation
    (bench.py:371-383). Returns the record, the warm state and the
    median trial's trajectory (the pilot of arm (c))."""
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu_torch.ops import fused_hmc_step, fused_leapfrog

    dens = zt.EquicorrelatedGaussianLogJoint("z", DIM, MIX_RHO)
    hmc = zt.HMC(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
                 adapt_mass=True, mass_collect_iters=50,
                 experimental_fused_step="auto" if fused else False,
                 experimental_fused_leapfrog=leapfrog_kernel)
    fns = (fused_hmc_step, fused_leapfrog)
    before = [f.launches for f in fns]
    st = hmc.init({"z": torch.zeros(MIX_CHAINS, DIM, device=dev)},
                  log_joint=dens)
    st, _ = hmc.run(dens, {}, st, torch.Generator().manual_seed(11),
                    MIX_ITERS, n_adapt=MIX_ITERS, collect=False)
    torch.cuda.synchronize()
    warm = [f.launches - b for f, b in zip(fns, before)]
    rec, out, traj = _timed_trials(
        torch, lambda seed: hmc.run(
            dens, {}, st, torch.Generator().manual_seed(seed), MIX_ITERS,
            collect_fields=("samples", "acceptance_rate"))[1], trials,
        launch_fns=fns)
    rec["mean_acceptance"] = _acceptance(out)[0]
    rec["step_size"] = float(st.step_size)
    rec["warmup_launches"] = warm
    rec["launch_counters"] = ["fused_hmc_step", "fused_leapfrog"]
    return rec, st, traj


def _mixing_chees(torch, dev, fused, trials):
    """Arm (b): ChEES-HMC (bench.py:386-394)."""
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu_torch.ops import fused_chees_step

    dens = zt.EquicorrelatedGaussianLogJoint("z", DIM, MIX_RHO)
    ch = zt.ChEESHMC(step_size=0.05, trajectory_length=1.0,
                     experimental_fused_step="auto" if fused else False)
    before = fused_chees_step.launches
    st = ch.init({"z": torch.zeros(MIX_CHAINS, DIM, device=dev)})
    st, _ = ch.run(dens, {}, st, torch.Generator().manual_seed(21),
                   MIX_ITERS, n_adapt=MIX_ITERS, collect=False)
    torch.cuda.synchronize()
    warm = fused_chees_step.launches - before
    rec, out, _ = _timed_trials(
        torch, lambda seed: ch.run(
            dens, {}, st, torch.Generator().manual_seed(seed),
            MIX_ITERS)[1], trials, launch_fns=(fused_chees_step,))
    rec["mean_acceptance"], rec["harmonic_acceptance"] = _acceptance(out)
    rec["step_size"] = float(st.step_size)
    rec["trajectory_length"] = float(torch.exp(st.log_traj))
    rec["mean_n_leapfrogs"] = float(out["n_leapfrogs"].double().mean())
    rec["warmup_launches"] = [warm]
    rec["launch_counters"] = ["fused_chees_step"]
    return rec


def _mixing_dense(torch, dev, warm_state, pilot_traj, trials):
    """Arm (c): pilot -> fit_dense_preconditioner -> whiten_log_joint ->
    HMC in whitened coordinates (bench.py:404-433)."""
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu_torch.ops import (
        fused_chees_step, fused_hmc_step, fused_leapfrog,
    )

    dens = zt.EquicorrelatedGaussianLogJoint("z", DIM, MIX_RHO)
    pilot = pilot_traj[::4].reshape(-1, DIM)
    zt.fit_dense_preconditioner(pilot)  # warm-up (cuSOLVER's first call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chol = zt.fit_dense_preconditioner(pilot)
    torch.cuda.synchronize()
    fit_sec = time.perf_counter() - t0
    wlj, to_w, from_w = zt.whiten_log_joint(dens, "z", chol)
    phmc = zt.HMC(step_size=0.5, n_leapfrogs=5, adapt_step_size=True)
    fns = (fused_hmc_step, fused_leapfrog, fused_chees_step)
    before = [f.launches for f in fns]
    pst = phmc.init({"z": to_w(warm_state.q["z"])}, log_joint=wlj)
    pst, _ = phmc.run(wlj, {}, pst, torch.Generator().manual_seed(31),
                      MIX_ITERS, n_adapt=MIX_ITERS, collect=False)
    rec, out, _ = _timed_trials(
        torch, lambda seed: phmc.run(
            wlj, {}, pst, torch.Generator().manual_seed(seed), MIX_ITERS,
            collect_fields=("samples", "acceptance_rate"))[1], trials,
        postmap=from_w)
    rec["launches"] = sum(f.launches - b for f, b in zip(fns, before))
    rec["why_no_launches"] = ("the whitened density is a plain callable, "
                              "not a built-in, so it takes the plain path")
    rec["mean_acceptance"] = _acceptance(out)[0]
    rec["step_size"] = float(pst.step_size)
    rec["pilot_fit_sec"] = fit_sec
    rec["pilot_draws"] = list(pilot.shape)
    budget = 3000 / float(MIX_ITERS)
    rec["ess_per_sec_amortized_3k_iters"] = (
        rec["min_coord_ess"] * budget / (fit_sec + rec["sample_sec"] * budget))
    return rec


def phase_mixing(torch, dev):
    from zhusuan_tpu_torch.ops import (
        fused_chees_step, fused_hmc_step, fused_leapfrog,
    )

    kernels = (fused_hmc_step, fused_leapfrog, fused_chees_step)
    for f in kernels:
        f.launches = 0
    arms = {}
    arms["hmc_fixed_L"], warm, pilot = _mixing_hmc(torch, dev, True, False,
                                                   N_TRIALS)
    k1 = fused_hmc_step.launches
    arms["hmc_fixed_L_leapfrog_kernel"], _, _ = _mixing_hmc(
        torch, dev, False, True, N_TRIALS)
    arms["chees"] = _mixing_chees(torch, dev, True, N_TRIALS)
    arms["hmc_dense_precond"] = _mixing_dense(torch, dev, warm, pilot,
                                              N_TRIALS)
    launches = {f.__name__: f.launches for f in kernels}
    for name, n in launches.items():
        check(n > 0, "the mixing run launched {} no time".format(name))
    check(launches["fused_hmc_step"] == k1,
          "an arm other than (a) launched the HMC step kernel")
    check(arms["hmc_dense_precond"]["launches"] == 0,
          "the whitened arm launched a kernel")
    # (a) and (b) on the plain path: one timed run each.
    arms["hmc_fixed_L_plain"], _, _ = _mixing_hmc(torch, dev, False, False, 1)
    arms["chees_plain"] = _mixing_chees(torch, dev, False, 1)
    print("phase11 mixing " + json.dumps({
        "target": "equicorrelated Gaussian rho={} dim={}".format(MIX_RHO,
                                                                 DIM),
        "n_chains": MIX_CHAINS, "n_adapt": MIX_ITERS, "n_iters": MIX_ITERS,
        "launches": launches, "arms": arms}))
    check(all(f.launches == launches[f.__name__] for f in kernels),
          "a plain-path arm launched a kernel")
    for name, rec in arms.items():
        if "harmonic_acceptance" in rec:
            check(abs(rec["harmonic_acceptance"] - 0.651) < 0.1,
                  "{}: harmonic-mean acceptance {:.3f}".format(
                      name, rec["harmonic_acceptance"]))
        else:
            lo = FIXED_L_MIN_ACCEPTANCE if "fixed_L" in name else 0.6
            check(lo <= rec["mean_acceptance"] <= 0.95,
                  "{}: mean acceptance {:.3f}".format(
                      name, rec["mean_acceptance"]))
    check(arms["chees"]["slow_proj_ess"]
          > arms["hmc_fixed_L"]["slow_proj_ess"],
          "ChEES's slow-projection ESS is not above fixed-L HMC's")
    return launches


# --------------------------------------------------------------------- #
# The least time the card could take for a kernel's work
# --------------------------------------------------------------------- #
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Operations per element the kernels spend, counted from their sources
# (csrc/*.cu): Philox4x32-10 and Box-Muller for one normal (the ten
# rounds' multiplies, xors and key adds per 4 normals; log, sqrt, cos or
# sin and the products per 2), and one evaluation of each built-in
# density's gradient and log-density. Integer and float64 operations (the
# equicorrelated row sums) are counted at the float32 rate.
OPS_NORMAL = 50
OPS_GRAD = {"diagonal": 3, "equicorrelated": 5}
OPS_LOG_PROB = {"diagonal": 5, "equicorrelated": 7}


def _bound(n_bytes, n_ops):
    """``{"bound_ms", "bound_by"}``: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def _hmc_step_bound(c, d, n_leapfrogs, density):
    """K1: reads q, writes q', p0 and five floats per chain; per element
    a normal, the momentum, two kinetic energies and log-densities,
    n_leapfrogs + 1 sub-steps (drift 3, gradient, kick 2) and the
    select."""
    ops = (OPS_NORMAL + 2 + 6 + 2 * OPS_LOG_PROB[density] + 1
           + (n_leapfrogs + 1) * (5 + OPS_GRAD[density]))
    return _bound(4 * (3 * c * d + 5 * c + 3 * d), c * d * ops)


def _leapfrog_bound(c, d, n_leapfrogs, density):
    """K2: reads q, p, writes q', p'; n_leapfrogs + 1 sub-steps."""
    return _bound(4 * (4 * c * d + d),
                  c * d * (n_leapfrogs + 1) * (5 + OPS_GRAD[density]))


def _chees_step_bound(c, d, n_leapfrogs, density):
    """K7: K1's work with the proposal (q', p') also written."""
    ops = (OPS_NORMAL + 2 + 6 + 2 * OPS_LOG_PROB[density] + 1
           + (n_leapfrogs + 1) * (5 + OPS_GRAD[density]))
    return _bound(4 * (4 * c * d + 3 * c + d), c * d * ops)


def _nuts_bound(c, d, total_leapfrogs):
    """K8/K9: reads q, writes q' and eight values per chain; per element a
    normal, and per leapfrog the drift, gradient and kick, the leaf's
    energy and the U-turn products (about 20), counted over the leapfrogs
    this run's trees took."""
    return _bound(4 * (2 * c * d + 8 * c + 2 * d),
                  c * d * OPS_NORMAL + total_leapfrogs * d * 20)


def _sgmcmc_bound(kind, c, d):
    """K3-K6 at ``[c, d]`` float32 on the diagonal density, on an iteration
    that does not resample: each reads its state once and writes it once;
    per element a normal, the gradient and the update's arithmetic."""
    n_state, n_out, update = {
        "sgld": (1, 1, 4), "psgld": (2, 2, 12), "sghmc": (2, 2, 11),
        "sgnht": (3, 3, 18)}[kind]
    extra = 4 * c if kind == "sghmc" else 0  # sum_d v'^2 per chain
    ops = OPS_NORMAL + OPS_GRAD["diagonal"] + update
    return _bound(4 * (n_state + n_out) * c * d + extra + 8 * d, c * d * ops)


# --------------------------------------------------------------------- #
# Phase 12: the SGMCMC kernels against their plain versions
# --------------------------------------------------------------------- #
SG_LR = 0.01  # phase 12's learning rate (SG_SAMPLERS' learning rates)


def _sg_cases():
    """``(label, kind, wrapper name, call)``: each kernel case of phase 12;
    ``call(fn, dens, state, noise, key)`` runs a wrapper or its plain
    version."""
    cases = [("sgld", "sgld", "fused_sgld_step", False,
              lambda fn, dn, s, nz, key: (fn(dn, s["q"], SG_LR, key, 3,
                                             noise=nz),)),
             ("psgld", "psgld", "fused_psgld_step", False,
              lambda fn, dn, s, nz, key: fn(dn, s["q"], s["rms"], SG_LR, 0.9,
                                            0.1, key, 3, noise=nz))]
    for order in (False, True):
        for resample in (False, True):
            def sghmc(fn, dn, s, nz, key, order=order, resample=resample):
                return fn(dn, s["q"], s["v"], SG_LR, 0.25, 0.0, order, key, 3,
                          resample=resample, noise=nz)
            cases.append(("sghmc order={} resample={}".format(
                2 if order else 1, resample), "sghmc", "fused_sghmc_step",
                resample, sghmc))
        def sgnht(fn, dn, s, nz, key, order=order):
            return fn(dn, s["q"], s["v"], s["alpha"], SG_LR, 0.1, 1.0, order,
                      key, 3, noise=nz)
        cases.append(("sgnht order={}".format(2 if order else 1), "sgnht",
                      "fused_sgnht_step", False, sgnht))
    return cases


def _sg_compare(torch, got, want):
    """Per output: the elements that differ at all, and the largest error
    relative to ``1 + |ref|`` (non-finite on both sides counts as
    equal)."""
    rec = []
    for g, w in zip(got, want):
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        fin = torch.isfinite(w)
        err = ((g - w).abs() / (1.0 + w.abs()))[fin]
        rec.append({"differing": int((~same).sum()),
                    "finite_mismatch": int((torch.isfinite(g) != fin).sum()),
                    "max_rel_err": float(err.max()) if err.numel() else 0.0,
                    "max_abs_err": float((g - w).abs()[fin].max())
                    if err.numel() else 0.0})
    return rec


def phase_sgmcmc_vs_plain(torch, dev):
    from zhusuan_tpu_torch import ops
    from zhusuan_tpu_torch.ops._random import (
        STREAM_SGMCMC_NOISE, STREAM_SGMCMC_RESAMPLE, philox_normal,
    )

    cases, failures = [], []
    max_err = {}
    key = (7, 8)
    for c, d in ((SG_CHAINS, DIM), (1000, 37)):
        for density in ("diagonal", "equicorrelated"):
            dens, q, _, _ = _family_problem(torch, dev, c, d, density, c + d)
            g = torch.Generator(device=dev).manual_seed(c - d)
            state = {
                "q": q,
                "v": 0.1 * torch.randn(c, d, generator=g, device=dev),
                "alpha": 0.1 + 0.02 * torch.randn(c, d, generator=g,
                                                  device=dev),
                "rms": 0.5 + 3.5 * torch.rand(c, d, generator=g, device=dev)}
            eps = philox_normal(key, 3, (c, d), STREAM_SGMCMC_NOISE, dev)
            eps_v = philox_normal(key, 3, (c, d), STREAM_SGMCMC_RESAMPLE, dev)
            for label, kind, wrapper, resample, call in _sg_cases():
                fn = getattr(ops, wrapper)
                ref = getattr(ops, wrapper + "_reference")
                noise = ((eps, eps_v if resample else None)
                         if kind in ("sghmc", "sgnht") else eps)
                # On the same Philox draws, injected into both sides.
                got = call(fn, dens, state, noise, key)
                torch.cuda.synchronize()
                want = call(ref, dens, state, noise, key)
                same_draws = _sg_compare(torch, got, want)
                # The kernel's own draws against the plain Philox.
                own = call(fn, dens, state, None, key)
                torch.cuda.synchronize()
                own_cmp = _sg_compare(torch, own, want)
                rec = {"case": label, "density": density, "shape": [c, d],
                       "same_draws": same_draws, "own_draws": own_cmp}
                cases.append(rec)
                worst = max(r["max_rel_err"] for r in same_draws + own_cmp)
                max_err[kind] = max(max_err.get(kind, 0.0), max(
                    r["max_abs_err"] for r in same_draws))
                if worst > Q_TOL or any(r["finite_mismatch"]
                                        for r in same_draws + own_cmp):
                    failures.append("{} {} {}x{}: relative error {}".format(
                        label, density, c, d, worst))
                if density == "diagonal" and any(r["differing"]
                                                 for r in same_draws):
                    failures.append("{} diagonal {}x{}: {} elements differ "
                                    "on the same draws".format(
                                        label, c, d, [r["differing"]
                                                      for r in same_draws]))

    # Times at the main path's width, diagonal density: each kernel with its
    # own Philox; its plain version with torch's generator, as the
    # samplers' plain paths draw.
    dens, q, _, _ = _family_problem(torch, dev, SG_CHAINS, DIM, "diagonal", 5)
    g = torch.Generator(device=dev).manual_seed(6)
    state = {"q": q, "v": 0.1 * torch.randn(SG_CHAINS, DIM, generator=g,
                                            device=dev),
             "alpha": torch.full((SG_CHAINS, DIM), 0.1, device=dev),
             "rms": torch.ones(SG_CHAINS, DIM, device=dev)}

    def draws():
        return torch.randn(SG_CHAINS, DIM, generator=g, device=dev)

    timing = {}
    for label, kind, wrapper, resample, call in _sg_cases():
        # The main path's cases: SGHMC and SGNHT second order, SGHMC on a
        # plain iteration.
        if resample or "order=1" in label:
            continue
        fn = getattr(ops, wrapper)
        ref = getattr(ops, wrapper + "_reference")
        plain_noise = ((lambda: (draws(), None)) if kind in ("sghmc", "sgnht")
                       else draws)
        def kernel():
            return call(fn, dens, state, None, (3, 4))

        timing[kind] = {
            "case": label,
            "kernel_ms": _time_ms(torch, kernel, 200),
            "kernel_graph_ms": _graph_ms(torch, kernel, 50),
            "plain_ms": _time_ms(torch, lambda: call(ref, dens, state,
                                                     plain_noise(), None), 20),
            **_sgmcmc_bound(kind, SG_CHAINS, DIM)}
    print("phase12 sgmcmc_vs_plain " + json.dumps({
        "timing_shape": [SG_CHAINS, DIM], "lr": SG_LR, "cases": cases,
        "timing": timing}))
    check(not failures, "; ".join(failures))
    return max_err, timing


# --------------------------------------------------------------------- #
# Phase 13: the SGMCMC samplers through their entry points
# --------------------------------------------------------------------- #
def _exact_variance(name, kwargs, std):
    """Per-dimension variance of phase 13's kept draws of SGLD or SGHMC on
    a zero-mean diagonal Gaussian of stds ``std`` (numpy). Both updates
    are linear there, so the covariance of (q, v) follows exactly, in
    float64, from the initial state (q = 0, v ~ sqrt(lr) N(0, 1)) through
    the resample schedule and the warm-up to each kept iteration; the
    mean over those. Also the stationary variance (without resampling)
    from the discrete Lyapunov equation ``S = A S A^T + Q``."""
    import numpy as np
    from scipy.linalg import solve_discrete_lyapunov

    lr = kwargs["learning_rate"]
    kept = [SG_WARMUP + i for i in range(SG_THINNING, SG_ITERS + 1,
                                         SG_THINNING)]
    out, stationary = [], []
    for s in std:
        if name == "SGLD":
            # q' = rho q + sqrt(lr) eps, rho = 1 - lr / (2 s^2)
            a = np.array([[1.0 - 0.5 * lr / s ** 2]])
            q_noise = np.array([[lr]])
            cov = np.zeros((1, 1))
            period = 0
        else:
            alpha = kwargs.get("friction", 0.25)
            beta = kwargs.get("variance_estimate", 0.0)
            period = kwargs.get("n_iter_resample_v", 20)
            dh = np.exp(-0.5 * alpha)
            k = dh * lr / s ** 2
            # Second order: q1 = q + v/2, v' = dh (dh v - lr q1 / s^2 + n),
            # q' = q1 + v'/2, n ~ N(0, 2 (alpha - beta) lr).
            a = np.array([[1.0 - 0.5 * k, 0.5 + 0.5 * dh ** 2 - 0.25 * k],
                          [-k, dh ** 2 - 0.5 * k]])
            b = dh * np.sqrt(2.0 * (alpha - beta) * lr) * np.array([0.5, 1.0])
            q_noise = np.outer(b, b)
            cov = np.diag([0.0, lr])
        acc = 0.0
        for t in range(kept[-1]):
            if period and t % period == 0:  # a fresh v ~ sqrt(lr) N(0, 1)
                cov = np.array([[cov[0, 0], 0.0], [0.0, lr]])
            cov = a @ cov @ a.T + q_noise
            if t + 1 in kept:
                acc += cov[0, 0]
        out.append(acc / len(kept))
        stationary.append(solve_discrete_lyapunov(a, q_noise)[0, 0])
    return np.array(out), np.array(stationary)


def _sg_run(torch, dev, name, fused, trials):
    """One sampler through ``init`` + ``run``: the warm-up, an untimed
    sampling run (kernel path), then ``trials`` timed sampling runs from
    the warm state with distinct keys. Returns the record and the last
    run's per-dimension variance (float64)."""
    import zhusuan_tpu_torch as zt

    std = torch.linspace(0.1, 1.0, DIM, device=dev)
    dens = zt.DiagonalGaussianLogJoint("x", torch.zeros(DIM, device=dev), std)
    sampler = getattr(zt, name)(
        experimental_fused_step="auto" if fused else False,
        **SG_SAMPLERS[name])

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    state = sampler.init({"x": torch.zeros(SG_CHAINS, DIM, device=dev)},
                         key=gen(60))
    t0 = time.perf_counter()
    state, _ = sampler.run(dens, {}, state, gen(61), SG_WARMUP,
                           collect=False)
    torch.cuda.synchronize()
    warm_sec = time.perf_counter() - t0
    if trials > 1:
        sampler.run(dens, {}, state, gen(62), SG_ITERS, thinning=SG_THINNING)
        torch.cuda.synchronize()
    dts = []
    for trial in range(trials):
        t0 = time.perf_counter()
        _, qs = sampler.run(dens, {}, state, gen(63 + trial), SG_ITERS,
                            thinning=SG_THINNING)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    x = qs["x"]
    check(bool(torch.isfinite(x).all()),
          "{} {} path: non-finite samples".format(name, "kernel" if fused
                                                  else "plain"))
    var = _pooled_std(torch, x) ** 2
    rate = [SG_CHAINS * SG_ITERS / dt for dt in dts]
    return {"path": "kernel" if fused else "plain",
            "warmup_sec": warm_sec, "sample_sec_trials": dts,
            "chain_iters_per_sec_M_trials": [r / 1e6 for r in rate],
            "chain_iters_per_sec_M": statistics.median(rate) / 1e6,
            "kept_draws": list(x.shape),
            "max_abs": float(x.abs().max())}, var.double().cpu()


def phase_sgmcmc_main_path(torch, dev):
    import numpy as np

    from zhusuan_tpu_torch import ops

    with open(SG_REFERENCE) as f:
        reference = json.load(f)
    for field, want in (("samplers", SG_SAMPLERS), ("warmup", SG_WARMUP),
                        ("iters", SG_ITERS), ("thinning", SG_THINNING)):
        check(reference[field] == want, "{} was made for another recipe "
              "({}); rerun scripts/sgmcmc_jax_reference.py".format(
                  SG_REFERENCE, field))
    kernels = {"SGLD": ops.fused_sgld_step, "PSGLD": ops.fused_psgld_step,
               "SGHMC": ops.fused_sghmc_step, "SGNHT": ops.fused_sgnht_step}
    std = np.linspace(0.1, 1.0, DIM)
    std_t = torch.linspace(0.1, 1.0, DIM, device=dev).double().cpu()
    runs, failures = {}, []

    def counted(fused):
        for f in kernels.values():
            f.launches = 0
        out = {}
        for name in kernels:
            before = {f.__name__: f.launches for f in kernels.values()}
            rec, var = _sg_run(torch, dev, name, fused,
                               N_TRIALS if fused else 1)
            rec["launches"] = {f.__name__: f.launches - before[f.__name__]
                               for f in kernels.values()}
            out[name] = (rec, var)
        return out, {f.__name__: f.launches for f in kernels.values()}

    kernel_runs, kernel_launches = counted(True)
    plain_runs, plain_launches = counted(False)
    for name in kernels:
        rec, var = kernel_runs[name]
        prec, pvar = plain_runs[name]
        ratio = (var / std_t ** 2).numpy()
        run = {"kernel": rec, "plain": prec,
               "kernel_over_plain": rec["chain_iters_per_sec_M"]
               / prec["chain_iters_per_sec_M"],
               "var_over_std2_kernel": ratio[[0, 10, 50, 99]].tolist(),
               "var_over_std2_plain": (pvar / std_t ** 2).numpy()[
                   [0, 10, 50, 99]].tolist()}
        jax_var = np.array(reference["runs"][name]["variance"])
        run["jax_var_over_std2"] = (jax_var / std ** 2)[[0, 10, 50, 99]]\
            .tolist()
        run["max_rel_err_vs_jax"] = {
            "kernel": float(np.abs(var.numpy() / jax_var - 1.0).max()),
            "plain": float(np.abs(pvar.numpy() / jax_var - 1.0).max())}
        gates = {}
        if name in ("SGLD", "SGHMC"):
            exact, stationary = _exact_variance(name, SG_SAMPLERS[name], std)
            run["exact_var_over_std2"] = (exact / std ** 2)[[0, 10, 50, 99]]\
                .tolist()
            run["stationary_var_over_std2"] = (stationary / std ** 2)[
                [0, 10, 50, 99]].tolist()
            for path, v in (("kernel", var), ("plain", pvar)):
                gates[path] = float(np.abs(v.numpy() / exact - 1.0).max())
            limit = SG_VAR_TOL
            run["gate"] = "per-dim variance vs exact"
        elif name == "SGNHT":
            gates = dict(run["max_rel_err_vs_jax"])
            limit = SG_REF_TOL
            run["gate"] = "per-dim variance vs the JAX package"
        else:
            gates["kernel_vs_plain"] = float(
                np.abs(var.numpy() / pvar.numpy() - 1.0).max())
            limit = SG_REF_TOL
            run["gate"] = "per-dim variance, kernel vs plain path"
        run["max_rel_err"] = gates
        for path, err in gates.items():
            if not err < limit:
                failures.append("{} {}: per-dim variance off by {:.4f} "
                                "(limit {})".format(name, path, err, limit))
        runs[name] = run
    # The warm-up, the untimed run (with more than one trial), the trials.
    want = SG_WARMUP + (N_TRIALS + (N_TRIALS > 1)) * SG_ITERS
    print("phase13 sgmcmc_main_path " + json.dumps({
        "target": "diagonal Gaussian, std linspace(0.1, 1.0), dim {}".format(
            DIM),
        "n_chains": SG_CHAINS, "warmup": SG_WARMUP, "iters": SG_ITERS,
        "thinning": SG_THINNING, "samplers": SG_SAMPLERS,
        "jax_reference": {k: reference[k] for k in ("script", "chains",
                                                    "jax", "device")},
        "kernel_path_launches": kernel_launches,
        "plain_path_launches": plain_launches, "runs": runs}))
    for name, f in kernels.items():
        rec = kernel_runs[name][0]
        check(rec["launches"][f.__name__] == want,
              "the {} kernel path launched {} {} times, not {}".format(
                  name, f.__name__, rec["launches"][f.__name__], want))
    check(all(n == 0 for n in plain_launches.values()),
          "the plain path launched a kernel: {}".format(plain_launches))
    check(not failures, "; ".join(failures))
    return kernel_launches, {n: r["kernel"]["chain_iters_per_sec_M"]
                             for n, r in runs.items()}


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
    fam_err, fam_timing = run_phase("phase10", phase_family_vs_plain, torch,
                                    dev)
    mix_launches = run_phase("phase11", phase_mixing, torch, dev)
    sg_err, sg_timing = run_phase("phase12", phase_sgmcmc_vs_plain, torch,
                                  dev)
    sg_launches, _ = run_phase("phase13", phase_sgmcmc_main_path, torch, dev)
    chees_t = fam_timing["chees_step_equicorrelated_n190"]
    nuts6 = nuts_timing["depth6"]

    def bound(rec):
        return {"bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None}

    sgmcmc = [{
        "name": "fused_{}_step".format(kind),
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/sgmcmc_step.cu",
        "replaces": "zhusuan_tpu/ops/{}_step.py:{}".format(kind, line),
        "launches": sg_launches["fused_{}_step".format(kind)],
        "max_abs_err": sg_err[kind],
        "ms": sg_timing[kind]["kernel_graph_ms"],
        "ms_back_to_back": sg_timing[kind]["kernel_ms"],
        "plain_ms": sg_timing[kind]["plain_ms"],
        **bound(sg_timing[kind]),
    } for kind, line in (("sgld", 86), ("psgld", 102), ("sghmc", 117),
                         ("sgnht", 124))]
    print(json.dumps({"kernels": [{
        "name": "fused_hmc_step",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/hmc_step.cu",
        "replaces": "zhusuan_tpu/ops/hmc_step.py:206",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound(_hmc_step_bound(N_CHAINS, DIM, 5, "diagonal")),
    }, {
        "name": "fused_nuts_transition",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/nuts_step.cu",
        "replaces": ["zhusuan_tpu/ops/nuts_step.py:331",
                     "zhusuan_tpu/ops/nuts_step.py:641"],
        "launches": nuts_launches,
        "max_abs_err": nuts_err,
        "ms": nuts6["kernel_ms"],
        "plain_ms": nuts6["plain_ms"],
        **bound(nuts6),
        "ms_depth10": nuts_timing["depth10"]["kernel_ms"],
        "plain_ms_depth10": nuts_timing["depth10"]["plain_ms"],
        "bound_ms_depth10": nuts_timing["depth10"]["bound_ms"],
    }, {
        "name": "fused_hmc_step (equicorrelated density)",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/hmc_step.cu",
        "replaces": "zhusuan_tpu/ops/hmc_step.py:206",
        "launches": mix_launches["fused_hmc_step"],
        "max_abs_err": fam_err["hmc_step"],
        "ms": fam_timing["hmc_step_equicorrelated_n5"]["kernel_ms"],
        "plain_ms": fam_timing["hmc_step_equicorrelated_n5"]["plain_ms"],
        **bound(_hmc_step_bound(MIX_CHAINS, DIM, 5, "equicorrelated")),
    }, {
        "name": "fused_leapfrog",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/hmc_step.cu",
        "replaces": "zhusuan_tpu/ops/leapfrog.py:128",
        "launches": mix_launches["fused_leapfrog"],
        "max_abs_err": fam_err["leapfrog"],
        "ms": fam_timing["leapfrog_equicorrelated_n5"]["kernel_ms"],
        "plain_ms": fam_timing["leapfrog_equicorrelated_n5"]["plain_ms"],
        **bound(_leapfrog_bound(MIX_CHAINS, DIM, 5, "equicorrelated")),
    }, {
        "name": "fused_chees_step",
        "route": "cuda",
        "source": "zhusuan_tpu_torch/csrc/hmc_step.cu",
        "replaces": "zhusuan_tpu/ops/chees_step.py:177",
        "launches": mix_launches["fused_chees_step"],
        "max_abs_err": fam_err["chees_step"],
        "ms": chees_t["kernel_ms"],
        "plain_ms": chees_t["plain_ms"],
        **bound(_chees_step_bound(MIX_CHAINS, DIM, 190, "equicorrelated")),
        "n_leapfrogs": 190,
    }] + sgmcmc}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
