"""The JAX package's numbers for ``chip_smoke.py`` phase 15 (the SVGP
training recipe), written to ``scripts/svgp_jax_reference.json``.

Runs ``examples/gaussian_process/svgp.py``'s model through the loss of
``baseline_ref/measure_configs_ours.py::build_svgp`` (``kzz_factors``, the
ELBO's ``sgvb``, ``optax.adam``) on the CPU in float32, with the recipe of
``baseline_ref/configs_protocol.py::SVGP``: 456 x 13 synthetic training rows
from data seed 42, 100 inducing points, 20 particles, full batch,
``Adam(1e-2)``, 30 warm-up then 600 steps. One run per key of ``--keys``;
each records the mean lower bound of the first and of the last
``chip_smoke.SVGP_TAIL`` steps, and the test RMSE and log-likelihood of the
example's predict step (100 particles) after training. The spread of those
numbers over the keys (eight by default: two keys' spread is too
narrow an estimate) sets phase 15's tolerance (three times the spread).

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/svgp_jax_reference.py
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
import optax  # noqa: E402
import zhusuan_tpu as zs  # noqa: E402
from baseline_ref import configs_protocol as P  # noqa: E402
from examples.gaussian_process import svgp  # noqa: E402
from zhusuan_tpu.utils import log_mean_exp  # noqa: E402


def run(seed, n_particles_test):
    cfg = P.SVGP
    x_train, y_train, x_test, y_test, std_y = P.regression_splits(cfg)
    n_train = len(x_train)
    n_z, n_particles = cfg["n_z"], cfg["n_particles"]
    params = svgp.init_params(jax.random.PRNGKey(1234), n_z, cfg["x_dim"],
                              x_train)
    optimizer = optax.adam(cfg["lr"])
    x, y = jnp.asarray(x_train), jnp.asarray(y_train)

    def loss_fn(params, key):
        chol, chol_inv = svgp.kzz_factors(params, n_z)
        model = svgp.build_model(params, x, n_z, n_particles, kzz_chol=chol,
                                 kzz_chol_inv=chol_inv)

        def log_joint(bn):
            prior, log_py_given_fx = bn.cond_log_prob(["fz", "y"])
            return prior + log_py_given_fx / n_train * n_train

        model.log_joint = log_joint
        latent = svgp.build_variational_samples(
            params, x, n_z, n_particles, key, kzz_chol=chol,
            kzz_chol_inv=chol_inv)
        lb = zs.variational.elbo(model, observed={"y": y}, latent=latent,
                                 axis=0)
        return jnp.mean(lb.sgvb()), jnp.mean(lb.tensor)

    def step(carry, key):
        params, opt_state = carry
        (_, lb), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key)
        updates, opt_state = optimizer.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state), lb

    @jax.jit
    def predict(params, key):
        """The example's predict step (svgp.py:200-219)."""
        k_q, k_m = jax.random.split(key)
        xt, yt = jnp.asarray(x_test), jnp.asarray(y_test)
        latent = svgp.build_variational_samples(params, xt, n_z,
                                                n_particles_test, k_q)
        model = svgp.build_model(params, xt, n_z, n_particles_test)
        bn = model.observe(k_m, fx=latent["fx"][0], y=yt)
        ll = jnp.mean(log_mean_exp(bn.cond_log_prob("y"), 0)
                      / xt.shape[0]) - jnp.log(std_y)
        y_pred = jnp.mean(bn["y"].dist.mean, axis=0)
        return jnp.sqrt(jnp.mean((y_pred - yt) ** 2)) * std_y, ll

    n_steps = cfg["warmup_steps"] + cfg["timed_steps"]
    keys = jax.random.split(jax.random.PRNGKey(seed), n_steps + 1)
    t0 = time.perf_counter()
    (params, _), lbs = jax.jit(lambda c, k: jax.lax.scan(step, c, k))(
        (params, optimizer.init(params)), keys[:-1])
    lbs = np.asarray(lbs, np.float64)
    rmse, ll = predict(params, keys[-1])
    tail = chip_smoke.SVGP_TAIL
    return {"first_lb": float(lbs[:tail].mean()),
            "final_lb": float(lbs[-tail:].mean()),
            "test_rmse": float(rmse), "test_ll": float(ll),
            "finite": bool(np.isfinite(lbs).all()),
            "cpu_seconds": time.perf_counter() - t0}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--keys", type=int, nargs="+",
                        default=list(range(8)))
    parser.add_argument("--out", default=chip_smoke.SVGP_REFERENCE)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    cfg = P.SVGP
    record = {
        "script": "scripts/svgp_jax_reference.py",
        "jax": jax.__version__, "device": "cpu", "dtype": "float32",
        "recipe": {"n_train": 456, "x_dim": cfg["x_dim"], "n_z": cfg["n_z"],
                   "n_particles": cfg["n_particles"], "lr": cfg["lr"],
                   "warmup_steps": cfg["warmup_steps"],
                   "timed_steps": cfg["timed_steps"],
                   "data_seed": cfg["data_seed"],
                   "n_particles_test": chip_smoke.SVGP_PARTICLES_TEST,
                   "tail": chip_smoke.SVGP_TAIL},
        "runs": {},
    }
    for seed in args.keys:
        r = run(seed, chip_smoke.SVGP_PARTICLES_TEST)
        record["runs"][str(seed)] = r
        print("key", seed, {k: round(v, 5) if isinstance(v, float) else v
                            for k, v in r.items()}, flush=True)
    runs = list(record["runs"].values())
    for field in ("final_lb", "test_rmse", "test_ll"):
        vals = [r[field] for r in runs]
        record[field] = {"mean": float(np.mean(vals)),
                         "spread": float(np.max(vals) - np.min(vals))}
    print({f: record[f] for f in ("final_lb", "test_rmse", "test_ll")})
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
