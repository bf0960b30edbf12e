"""The JAX package's numbers for ``chip_smoke.py`` phase 33's change-point
gate, written to ``scripts/changepoint_jax_reference.json``.

Runs ``examples/state_space/changepoint.py``'s ``run`` at its defaults
(``t`` 60, 64 chains, 2000 sweeps, 500 burn-in, seed 0) on the CPU, and
records its 60 synthetic counts (``make_data``'s Poisson draws, which the
port's ``run(y=...)`` takes), ``tau_mode``, ``tau_mean``, ``lam_mean`` and
the histogram of the kept ``tau`` draws.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/changepoint_jax_reference.py
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples.state_space import changepoint  # noqa: E402

OUT = os.path.join(ROOT, "scripts", "changepoint_jax_reference.json")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    defaults = {"t": 60, "n_chains": 64, "n_iters": 2000, "burnin": 500,
                "seed": 0}
    y, _ = changepoint.make_data(defaults["t"],
                                 jax.random.PRNGKey(defaults["seed"]))
    t0 = time.perf_counter()
    res = changepoint.run(**defaults)
    seconds = time.perf_counter() - t0
    tau = res["tau_draws"].astype(np.int64)
    commit = subprocess.run(["git", "rev-parse", "HEAD"],
                            capture_output=True, text=True,
                            cwd=ROOT).stdout.strip()
    record = {
        "script": "scripts/changepoint_jax_reference.py",
        "jax": jax.__version__, "device": "cpu",
        "dtype": str(np.asarray(y).dtype), "commit": commit,
        "recipe": defaults, "seconds": seconds,
        "y": [float(v) for v in np.asarray(y)],
        "tau_mode": res["tau_mode"], "tau_mean": res["tau_mean"],
        "lam_mean": [float(v) for v in res["lam_mean"]],
        "tau_histogram": {str(k): int(v) for k, v in
                          zip(*np.unique(tau, return_counts=True))},
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in ("tau_mode", "tau_mean",
                                             "lam_mean", "seconds")}))


if __name__ == "__main__":
    main()
