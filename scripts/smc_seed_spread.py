"""The seed-to-seed spread of ``chip_smoke.py`` phase 34 (a): annealed SMC
on ``bench.py``'s target at 32768 particles x 100 dims, the HMC run (K1 on
the tempered bridge, ``prior_density=``) and the adaptive MALA run, each at
``--seeds`` seeds. Prints, for each run and seed, log Z's error against the
closed form and the largest relative error of the pooled stds, then their
mean, standard deviation and largest magnitude over the seeds: the readings
that phase 34's ``SMC_LOGZ_TOL`` and ``SMC_STD_TOL`` are set from. Writes
the lines to ``chiprun_out/smc_seed_spread.json`` as well.

    python3 scripts/smc_seed_spread.py [--seeds 8]
"""

import argparse
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import zhusuan_tpu_torch as zt  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.phase_device(torch), flush=True)
    std, dens, prior, proposal, log_z_true = cs._smc_target(torch, dev)
    runs = {
        "hmc_fixed": lambda: (zt.AnnealedSMC(
            dens, proposal(), zt.HMC(step_size=cs.SMC_HMC_STEP,
                                     n_leapfrogs=cs.SMC_HMC_LEAPFROGS),
            observed={}, latent=["x"], n_temperatures=cs.SMC_TEMPS,
            n_moves=2, prior_density=prior), "run"),
        "mala_adaptive": lambda: (zt.AnnealedSMC(
            dens, proposal(), zt.MALA(step_size=cs.SMC_MALA_STEP),
            observed={}, latent=["x"], n_temperatures=cs.SMC_TEMPS,
            n_moves=cs.SMC_MALA_MOVES), "run_adaptive"),
    }
    lines = []
    for name, make in runs.items():
        errs, stds = [], []
        for seed in range(args.seeds):
            smc, method = make()
            res, seconds = cs._wall(torch, lambda: getattr(smc, method)(
                (1000 + seed, 0)))
            x = res.particles["x"].double()
            errs.append(float(res.log_z) - log_z_true)
            stds.append(float((x.std(0) / std.double() - 1.0).abs().max()))
            lines.append({"run": name, "seed": 1000 + seed,
                          "log_z_err": errs[-1],
                          "max_std_rel_err": stds[-1],
                          "temperatures": res.n_steps, "wall_sec": seconds})
            print(json.dumps(lines[-1]), flush=True)
        lines.append({"run": name, "seeds": args.seeds,
                      "log_z_err_mean": statistics.mean(errs),
                      "log_z_err_sd": statistics.stdev(errs),
                      "log_z_err_max_abs": max(abs(e) for e in errs),
                      "max_std_rel_err_mean": statistics.mean(stds),
                      "max_std_rel_err_max": max(stds)})
        print(json.dumps(lines[-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "smc_seed_spread.json"),
              "w") as f:
        f.write("\n".join(json.dumps(v) for v in lines) + "\n")


if __name__ == "__main__":
    main()
