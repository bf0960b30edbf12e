"""The JAX package's numbers for ``chip_smoke.py`` phase 32(c)
(multi-path Pathfinder on ``bench.py``'s target), written to
``scripts/pathfinder_jax_reference.json``.

Runs ``zhusuan_tpu.variational.multipath_pathfinder`` on the CPU in float64
with phase 32's recipe: the 100-dim diagonal Gaussian, loc 0 and std
``linspace(0.1, 1.0, 100)`` (``bench.py:69-74``), ``chip_smoke.PF_PATHS``
paths from ``N(0, PF_INIT_SCALE^2 I)`` starts, ``PF_PER_PATH`` draws a path,
``PF_DRAWS`` resampled, ``PF_ITERS`` L-BFGS iterations, the defaults
otherwise (``history`` 6, 30 ELBO draws). One run per key of ``--keys``
(four by default, each key also drawing its own starts); for each it
records the Pareto-k of the pooled ratios, the largest ``|mean| / std`` and
the largest ``|sd / std - 1|`` of the resampled draws. Their range sets
phase 32's gates.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/pathfinder_jax_reference.py
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
from zhusuan_tpu.variational import multipath_pathfinder  # noqa: E402


def recipe():
    return {"dim": chip_smoke.DIM, "n_paths": chip_smoke.PF_PATHS,
            "n_draws_per_path": chip_smoke.PF_PER_PATH,
            "n_draws": chip_smoke.PF_DRAWS, "max_iters": chip_smoke.PF_ITERS,
            "init_scale": chip_smoke.PF_INIT_SCALE}


def one(key):
    std = jnp.linspace(0.1, 1.0, chip_smoke.DIM)

    def log_joint(obs):
        return jnp.sum(-0.5 * (obs["x"] / std) ** 2, -1)

    k_init, k_run = jax.random.split(jax.random.PRNGKey(key))
    inits = chip_smoke.PF_INIT_SCALE * jax.random.normal(
        k_init, (chip_smoke.PF_PATHS, chip_smoke.DIM), jnp.float64)
    t0 = time.perf_counter()
    res = multipath_pathfinder(
        log_joint, {}, {"x": inits}, k_run, n_draws=chip_smoke.PF_DRAWS,
        n_draws_per_path=chip_smoke.PF_PER_PATH,
        max_iters=chip_smoke.PF_ITERS)
    x = np.asarray(res.draws["x"])
    std = np.asarray(std)
    return {"key": key, "seconds": time.perf_counter() - t0,
            "khat": float(res.khat),
            "max_abs_mean_over_std": float(np.abs(x.mean(0) / std).max()),
            "max_rel_std_err": float(np.abs(x.std(0) / std - 1.0).max()),
            "path_elbos": [float(v) for v in np.asarray(res.path_elbos)]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--keys", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--out", default=chip_smoke.PF_REFERENCE)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    commit = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    runs = [one(k) for k in args.keys]
    record = {"script": "scripts/pathfinder_jax_reference.py",
              "jax": jax.__version__, "device": "cpu", "dtype": "float64",
              "commit": commit, "recipe": recipe(), "runs": runs}
    for f in ("khat", "max_abs_mean_over_std", "max_rel_std_err"):
        vals = [r[f] for r in runs]
        record[f] = {"min": min(vals), "max": max(vals),
                     "mean": float(np.mean(vals))}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in (
        "khat", "max_abs_mean_over_std", "max_rel_std_err")}))


if __name__ == "__main__":
    main()
