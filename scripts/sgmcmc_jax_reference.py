"""The JAX package's numbers for ``chip_smoke.py`` phase 13 (the SGMCMC
samplers on ``bench.py``'s target), written to
``scripts/sgmcmc_jax_reference.json``.

Runs each sampler of ``chip_smoke.SG_SAMPLERS`` through
``zhusuan_tpu``'s ``init`` and ``run`` on the CPU in float32 with the
phase's recipe (``SG_WARMUP`` iterations, then ``SG_ITERS`` kept every
``SG_THINNING``-th) at ``--chains`` chains (the chains are independent, so
fewer chains than the phase's only widen the sampling error), and records
each dimension's variance over the kept draws in float64. Phase 13 holds
the port's SGNHT to these variances; the others are there for comparison.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/sgmcmc_jax_reference.py
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import zhusuan_tpu as zs  # noqa: E402


def pooled_variance(samples):
    """Per-dimension variance of ``[T, C, D]`` draws, in float64."""
    x = np.asarray(samples, np.float64).reshape(-1, samples.shape[-1])
    return x.var(axis=0)


def run(name, kwargs, chains, seed):
    dim = chip_smoke.DIM
    std = jnp.linspace(0.1, 1.0, dim, dtype=jnp.float32)

    def log_joint(obs):  # bench.py:72-74
        return jnp.sum(-0.5 * (obs["x"] / std) ** 2, -1)

    sampler = getattr(zs, name)(**kwargs)
    k_init, k_warm, k_run = jax.random.split(jax.random.PRNGKey(seed), 3)
    state = sampler.init({"x": jnp.zeros((chains, dim), jnp.float32)},
                         key=k_init)
    warm = jax.jit(lambda s, k: sampler.run(
        log_joint, {}, s, k, chip_smoke.SG_WARMUP, collect=False)[0])
    sample = jax.jit(lambda s, k: sampler.run(
        log_joint, {}, s, k, chip_smoke.SG_ITERS,
        thinning=chip_smoke.SG_THINNING)[1])
    t0 = time.perf_counter()
    state = warm(state, k_warm)
    qs = np.asarray(sample(state, k_run)["x"])
    seconds = time.perf_counter() - t0
    var = pooled_variance(qs)
    return {"variance": var.tolist(), "finite": bool(np.isfinite(qs).all()),
            "max_abs": float(np.abs(qs).max()),
            "variance_over_std2": (var / np.asarray(std, np.float64) ** 2)
            .tolist(), "cpu_seconds": seconds}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=8192)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=chip_smoke.SG_REFERENCE)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    record = {
        "script": "scripts/sgmcmc_jax_reference.py",
        "jax": jax.__version__, "device": "cpu", "dtype": "float32",
        "chains": args.chains, "seed": args.seed, "dim": chip_smoke.DIM,
        "target": "diagonal Gaussian, std linspace(0.1, 1.0), loc 0",
        "warmup": chip_smoke.SG_WARMUP, "iters": chip_smoke.SG_ITERS,
        "thinning": chip_smoke.SG_THINNING,
        "samplers": chip_smoke.SG_SAMPLERS, "runs": {},
    }
    for name, kwargs in chip_smoke.SG_SAMPLERS.items():
        record["runs"][name] = run(name, kwargs, args.chains, args.seed)
        r = record["runs"][name]
        print(name, "finite", r["finite"], "var/std^2 at dims 0, 10, 50, 99:",
              [round(r["variance_over_std2"][i], 4) for i in (0, 10, 50, 99)],
              "{:.1f} s".format(r["cpu_seconds"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
