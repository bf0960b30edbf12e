"""Where the time goes on the card in the SMC and state-space loops
(PERF.md section 5), at chip_smoke.py phase 34's shapes: a bootstrap
particle-filter step on ``tests/test_ssm.py``'s linear-Gaussian model at
65536 particles, a PMMH iteration of ``stochastic_volatility`` (8 vmapped
filters of 200 steps, 512 particles), an annealed-SMC temperature on
``bench.py``'s target at 32768 x 100 (2 HMC moves x 5 leapfrogs, on the
plain transition and on K1 with the tempered bridge), and one step of the
sequential ``hmm_filter`` (K = 64) and ``kalman_filter`` (d = 4), beside
one call of each ``parallel=True`` path at T = 16384.

Each is run once to warm up, then under ``torch.profiler``
(``scripts/profile_slice_changepoint.py``'s ``measure``: wall and device
time per unit, the device's share, kernels, host reads and stream syncs
per unit, the five ops with the most host time). Prints one JSON line per
loop and writes them to ``chiprun_out/profile_smc_ssm.json``.

    python3 scripts/profile_smc_ssm.py
"""

import json
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
import zhusuan_tpu_torch as zt  # noqa: E402
from profile_slice_changepoint import measure  # noqa: E402


def main(device="cuda:0"):
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    print(cs.phase_device(torch), flush=True)
    recs = []

    ys, A, Q, H, R, m0, P0 = cs._lgssm(torch, dev, 100, 34)
    chol_q = torch.linalg.cholesky(Q)
    pf = zt.ParticleFilter(
        lambda g, n: torch.randn(n, 2, generator=g, dtype=torch.float64,
                                 device=dev),
        lambda g, x, t: x @ A.T + torch.randn(
            x.shape, generator=g, dtype=x.dtype, device=dev) @ chol_q.T,
        lambda x, y, t: torch.sum(-0.5 * (y - x @ H.T) ** 2 / 0.5
                                  - 0.5 * math.log(math.pi), -1),
        n_particles=cs.FILTER_PARTICLES)
    recs.append(measure("particle-filter step, 65536 particles", lambda:
                        pf.run((1, 2), ys), 100))

    from zhusuan_tpu_torch.examples.state_space import stochastic_volatility
    _, ys_np, _ = stochastic_volatility.simulate(200)
    sv_ys = torch.tensor(ys_np, dtype=torch.float64, device=dev)
    recs.append(measure(
        "PMMH iteration, 8 chains x 512 particles x 200 steps",
        lambda: stochastic_volatility.run_pmmh(
            sv_ys, cs.SV_PARTICLES, cs.SV_CHAINS, 5), 5))

    _, dens, prior, proposal, _ = cs._smc_target(torch, dev)
    for route, prior_density in (("the plain transition", None),
                                 ("K1 on the tempered bridge", prior)):
        smc = zt.AnnealedSMC(dens, proposal(), zt.HMC(
            step_size=cs.SMC_HMC_STEP, n_leapfrogs=cs.SMC_HMC_LEAPFROGS),
            observed={}, latent=["x"], n_temperatures=10, n_moves=2,
            prior_density=prior_density)
        recs.append(measure(
            "SMC temperature, 32768 x 100, 2 HMC moves, " + route,
            lambda: smc.run((3, 4)), 10))
    g = torch.Generator(device=dev).manual_seed(35)
    log_pi0 = torch.log_softmax(torch.randn(
        cs.SCAN_K, generator=g, device=dev, dtype=torch.float64), 0)
    log_trans = torch.log_softmax(3.0 * torch.randn(
        cs.SCAN_K, cs.SCAN_K, generator=g, device=dev, dtype=torch.float64),
        1)
    log_obs = torch.randn(cs.SCAN_T, cs.SCAN_K, generator=g, device=dev,
                          dtype=torch.float64)
    recs.append(measure("hmm_filter step, K = 64, sequential", lambda:
                        zt.hmm_filter(log_pi0, log_trans, log_obs[:256],
                                      parallel=False),
                        256))
    recs.append(measure("hmm_filter, K = 64, T = 16384, parallel", lambda:
                        zt.hmm_filter(log_pi0, log_trans, log_obs,
                                      parallel=True), 1))
    rng = np.random.default_rng(36)
    kargs = [torch.tensor(a, dtype=torch.float64, device=dev) for a in (
        rng.standard_normal((cs.SCAN_T, 2)),
        0.9 * np.linalg.qr(rng.standard_normal((cs.SCAN_D, cs.SCAN_D)))[0],
        0.1 * np.eye(cs.SCAN_D), rng.standard_normal((2, cs.SCAN_D)),
        0.5 * np.eye(2), np.zeros(cs.SCAN_D), np.eye(cs.SCAN_D))]
    recs.append(measure("kalman_filter step, d = 4, sequential", lambda:
                        zt.kalman_filter(kargs[0][:256], *kargs[1:],
                                         parallel=False), 256))
    recs.append(measure("kalman_filter, d = 4, T = 16384, parallel",
                        lambda: zt.kalman_filter(*kargs, parallel=True), 1))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_smc_ssm.json"), "w") as f:
        json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
