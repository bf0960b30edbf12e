"""The JAX package's numbers for ``chip_smoke.py`` phase 18 (the toy2d ADVI
recipe), written to ``scripts/advi_jax_reference.json``.

Runs ``zhusuan_tpu.variational.advi`` on the two-node model of
``examples/toy_examples/toy2d_intractable.py`` (``z2 ~ N(0, 1.35)``,
``z1 ~ N(0, e^{z2})``) through its ``lax.scan`` path
(``experimental_fused=False``) on the CPU in float32, with the recipe of
``baseline_ref/configs_protocol.py::TOY2D``: mean-field guide from loc -2,
log-scale -5, 500 particles, Adam at a constant 0.1, 50 warm-up + 16000
steps in one fit. One run per key of ``--keys``; each records the fitted
``loc`` and ``log_scale`` (in the order z1, z2, the port's one latent
``[z1, z2]``), the mean loss of the first ``chip_smoke.TOY2D_WARMUP`` steps
and of the last ``chip_smoke.TOY2D_TAIL``. At a constant rate of 0.1 the
parameters jitter around the optimum, so the spread of those numbers over the
keys (eight by default) sets phase 18's tolerance (three times the spread).

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/advi_jax_reference.py
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

FIELDS = ("loc_z1", "loc_z2", "log_scale_z1", "log_scale_z2", "first_loss",
          "tail_loss")


@zs.meta_bayesian_net()
def toy2d():
    bn = zs.BayesianNet()
    z2 = bn.normal("z2", 0.0, std=chip_smoke.TOY2D_SCALE)
    bn.normal("z1", 0.0, logstd=z2.tensor)
    return bn


def recipe():
    return {"n_particles": chip_smoke.TOY2D_PARTICLES,
            "n_steps": chip_smoke.TOY2D_WARMUP + chip_smoke.TOY2D_STEPS,
            "lr": chip_smoke.TOY2D_LR, "init_loc": chip_smoke.TOY2D_INIT[0],
            "init_log_scale": chip_smoke.TOY2D_INIT[1],
            "scale": chip_smoke.TOY2D_SCALE, "first": chip_smoke.TOY2D_WARMUP,
            "tail": chip_smoke.TOY2D_TAIL}


def run(seed):
    rec = recipe()
    init = {kind: {n: jnp.asarray(v, jnp.float32) for n in ("z1", "z2")}
            for kind, v in (("loc", rec["init_loc"]),
                            ("log_scale", rec["init_log_scale"]))}
    t0 = time.perf_counter()
    res = zs.variational.advi(
        toy2d(), {}, jax.random.PRNGKey(seed), n_iters=rec["n_steps"],
        n_samples=rec["n_particles"], lr_schedule=lambda t: rec["lr"],
        init_params=init, experimental_fused=False)
    losses = np.asarray(res.losses, np.float64)
    out = {"first_loss": float(losses[:rec["first"]].mean()),
           "tail_loss": float(losses[-rec["tail"]:].mean()),
           "finite": bool(np.isfinite(losses).all()),
           "cpu_seconds": time.perf_counter() - t0}
    for kind in ("loc", "log_scale"):
        for n in ("z1", "z2"):
            out["{}_{}".format(kind, n)] = float(res.params[kind][n])
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--keys", type=int, nargs="+",
                        default=list(range(8)))
    parser.add_argument("--out", default=chip_smoke.ADVI_REFERENCE)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    commit = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    record = {"script": "scripts/advi_jax_reference.py",
              "jax": jax.__version__, "device": "cpu", "dtype": "float32",
              "commit": commit, "recipe": recipe(), "runs": {}}
    for seed in args.keys:
        r = run(seed)
        record["runs"][str(seed)] = r
        print("key", seed, {k: round(v, 5) if isinstance(v, float) else v
                            for k, v in r.items()}, flush=True)
    runs = list(record["runs"].values())
    for field in FIELDS:
        vals = [r[field] for r in runs]
        record[field] = {"mean": float(np.mean(vals)),
                         "spread": float(np.max(vals) - np.min(vals))}
    print({f: record[f] for f in FIELDS})
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
