"""The JAX package's numbers for ``chip_smoke.py`` phase 36's covariance
example, written to ``scripts/covariance_jax_reference.json``.

Runs ``examples/hierarchical/covariance_estimation.py`` on the CPU at its
defaults (n 300, 16 chains, 1200 iterations, 400 burn-in, depth 6, seed 2)
in float32, as the example runs (no x64): its synthetic data
(``make_data``'s ``jax.random`` draws, which the port's ``run(data=...)``
takes) and the posterior summaries ``run`` returns.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/covariance_jax_reference.py
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples.hierarchical import covariance_estimation  # noqa: E402

OUT = os.path.join(ROOT, "scripts", "covariance_jax_reference.json")


def _nested(v):
    return np.asarray(v, np.float64).tolist()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    recipe = {"n": 300, "n_chains": 16, "n_iters": 1200, "burnin": 400,
              "seed": 2}
    x, synthetic = covariance_estimation.make_data(
        recipe["n"], jax.random.PRNGKey(recipe["seed"]))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = covariance_estimation.run(**recipe)
    seconds = time.perf_counter() - t0
    rec = {"script": "scripts/covariance_jax_reference.py",
           "jax": jax.__version__, "device": "cpu", "recipe": recipe,
           "max_tree_depth": 6, "dtype": str(np.asarray(x).dtype),
           "synthetic": bool(synthetic), "x": _nested(x),
           **{k: _nested(res[k]) for k in ("scale_mean", "corr_mean",
                                           "cov_mean", "cov_sd",
                                           "sample_cov")},
           "seconds": seconds}
    rec["commit"] = subprocess.run(["git", "rev-parse", "HEAD"],
                                   capture_output=True, text=True,
                                   cwd=ROOT).stdout.strip()
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
        fh.write("\n")
    print(json.dumps({"seconds": seconds,
                      "scale_mean": rec["scale_mean"]}))


if __name__ == "__main__":
    main()
