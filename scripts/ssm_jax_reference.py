"""The JAX package's numbers for ``chip_smoke.py`` phase 34's SMC and
state-space gates, written to ``scripts/ssm_jax_reference.json`` (the GPU
host has no JAX).

Runs, on the CPU in float64 (the JAX tests' ``jax_enable_x64``):

- ``examples/state_space/stochastic_volatility.py`` at phase 34's recipe
  (T = 200, ``SV_PARTICLES`` particles, ``SV_CHAINS`` chains,
  ``SV_ITERS`` PMMH iterations, ``SV_BURNIN`` burn-in; the phase's cut of
  the example's 1500 / 300) over ``--keys`` seeds: the filter's RMSE(h)
  at the true parameters and PMMH's acceptance and posterior means of
  ``(mu, phi, sigma)``, each seed's and their range;
- ``examples/model_comparison/bayes_factor_smc.py``'s ``main()`` at its
  defaults (4000 particles): each degree's estimate and closed form.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/ssm_jax_reference.py
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

import chip_smoke  # noqa: E402  (the recipe's constants; imports no torch)

OUT = os.path.join(ROOT, "scripts", "ssm_jax_reference.json")


def sv_run(sv, seed, recipe):
    import jax.numpy as jnp

    hs_true, ys, _ = sv.simulate(recipe["t"])
    theta_true = {
        "mu": jnp.asarray(sv.TRUE["mu"]),
        "phi_u": jnp.arctanh(jnp.asarray(sv.TRUE["phi"])),
        "log_sigma": jnp.log(jnp.asarray(sv.TRUE["sigma"])),
    }
    res = sv.make_filter(theta_true, jnp.asarray(ys),
                         recipe["n_particles"]).run(
        jax.random.PRNGKey(1), jnp.asarray(ys))
    rmse = float(jnp.sqrt(jnp.mean(
        (res.filter_means - jnp.asarray(hs_true)) ** 2)))
    t0 = time.perf_counter()
    _, out = sv.run_pmmh(ys, recipe["n_particles"], recipe["n_chains"],
                         recipe["n_iters"], seed=seed)
    acc = float(np.asarray(out["acceptance_rate"]).mean())
    seconds = time.perf_counter() - t0
    draws = {k: np.asarray(v)[recipe["burnin"]:]
             for k, v in out["samples"].items()}
    return {"seed": seed, "filter_rmse": rmse,
            "filter_log_z": float(res.log_z), "acceptance": acc,
            "mu": float(draws["mu"].mean()),
            "phi": float(np.tanh(draws["phi_u"]).mean()),
            "sigma": float(np.exp(draws["log_sigma"]).mean()),
            "pmmh_seconds": seconds}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--keys", type=int, default=4)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.argv = sys.argv[:1]  # the SV example parses flags at import
    from examples.model_comparison import bayes_factor_smc
    from examples.state_space import stochastic_volatility as sv

    recipe = {"t": 200, "n_particles": chip_smoke.SV_PARTICLES,
              "n_chains": chip_smoke.SV_CHAINS,
              "n_iters": chip_smoke.SV_ITERS,
              "burnin": chip_smoke.SV_BURNIN}
    runs = [sv_run(sv, seed, recipe) for seed in range(args.keys)]
    summary = {k: {"min": min(r[k] for r in runs),
                   "max": max(r[k] for r in runs),
                   "mean": float(np.mean([r[k] for r in runs]))}
               for k in ("acceptance", "mu", "phi", "sigma")}
    bf = bayes_factor_smc.main()
    commit = subprocess.run(["git", "rev-parse", "HEAD"],
                            capture_output=True, text=True,
                            cwd=ROOT).stdout.strip()
    record = {
        "script": "scripts/ssm_jax_reference.py",
        "jax": jax.__version__, "device": "cpu", "dtype": "float64",
        "commit": commit, "recipe": {"sv": recipe},
        "sv": {"runs": runs, "summary": summary},
        "bayes_factor": {str(d): {"estimate": float(e), "truth": float(t)}
                         for d, (e, t) in bf.items()},
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
