"""The JAX package's numbers for ``chip_smoke.py`` phase 27 (AIS at full
width), written to ``scripts/ais_jax_reference.json``.

Runs ``zhusuan_tpu.evaluation.AIS`` on the CPU in float32 with phase 27's
recipe: ``z ~ N(0, I_100)``, ``x | z ~ N(z, I)`` with one observed ``x``
drawn from ``chip_smoke.AIS_SEED`` (``x ~ N(0, 2 I)``, its marginal), the
proposal ``N(0, I)``, ``HMC(step_size=0.3, n_leapfrogs=5,
adapt_step_size=True)``, 4096 chains, 1000 temperatures and 30 adaptation
iterations (``AIS``'s defaults). One estimate per key of ``--keys`` (eight
by default); their mean and spread (max - min) set phase 27's gate, beside
the analytic ``log Z = sum_d log N(x_d; 0, sqrt 2)``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/ais_jax_reference.py
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import zhusuan_tpu as zs  # noqa: E402
from zhusuan_tpu.evaluation import AIS  # noqa: E402


def recipe():
    return {"n_chains": chip_smoke.AIS_CHAINS, "dim": chip_smoke.AIS_DIM,
            "n_temperatures": chip_smoke.AIS_TEMPS,
            "n_adapt": chip_smoke.AIS_ADAPT, "step_size": chip_smoke.AIS_STEP,
            "n_leapfrogs": chip_smoke.AIS_LEAPFROGS,
            "seed": chip_smoke.AIS_SEED}


def make_ais():
    c, d = chip_smoke.AIS_CHAINS, chip_smoke.AIS_DIM
    x_obs = chip_smoke.ais_observation()

    @zs.meta_bayesian_net()
    def model():
        bn = zs.BayesianNet()
        z = bn.normal("z", jnp.zeros((c, d)), std=1.0, group_ndims=1)
        bn.normal("x", z.tensor, std=1.0, group_ndims=1)
        return bn

    @zs.meta_bayesian_net()
    def proposal():
        bn = zs.BayesianNet()
        bn.normal("z", jnp.zeros((c, d)), std=1.0, group_ndims=1)
        return bn

    hmc = zs.HMC(step_size=chip_smoke.AIS_STEP,
                 n_leapfrogs=chip_smoke.AIS_LEAPFROGS, adapt_step_size=True)
    return AIS(model(), proposal(), hmc,
               observed={"x": jnp.asarray(x_obs, jnp.float32)},
               latent=["z"], n_temperatures=chip_smoke.AIS_TEMPS,
               n_adapt=chip_smoke.AIS_ADAPT)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--keys", type=int, nargs="+",
                        default=list(range(8)))
    parser.add_argument("--out", default=chip_smoke.AIS_REFERENCE)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    commit = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    record = {"script": "scripts/ais_jax_reference.py",
              "jax": jax.__version__, "device": "cpu", "dtype": "float32",
              "commit": commit, "recipe": recipe(),
              "log_z": chip_smoke.ais_log_z(), "runs": {}}
    run = jax.jit(make_ais().run)
    for seed in args.keys:
        t0 = time.perf_counter()
        est = float(run(jax.random.PRNGKey(seed)))
        record["runs"][str(seed)] = {
            "estimate": est, "cpu_seconds": time.perf_counter() - t0}
        print("key", seed, est, flush=True)
    vals = [r["estimate"] for r in record["runs"].values()]
    record["estimate"] = {"mean": float(np.mean(vals)),
                          "spread": float(np.max(vals) - np.min(vals))}
    print(record["estimate"], "log Z", record["log_z"])
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
