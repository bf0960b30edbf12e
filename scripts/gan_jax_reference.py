"""The JAX package's GAN training-dynamics numbers over seeds, written to
``scripts/gan_jax_reference.json``.

``tests/test_examples.py``'s ``test_dcgan_training_dynamics`` and
``test_wgan_training_dynamics`` gate one run each, at the examples' fixed
key 1234: the generator's brightness gap to the data after training over
the gap at the start (DCGAN 8 epochs, bound 0.85; WGAN 5 epochs, bound
0.15) and the trained discriminator's accuracy (DCGAN, bound 0.8). This
script runs the same recipes at keys 1234 .. 1234 + n - 1 (the examples'
``PRNGKey(1234)`` replaced by the run's key), so the port's numbers
(``chip_smoke.py`` phase 36) can be read against the spread of the
reference's own.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/gan_jax_reference.py
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from examples.generative_adversarial_nets import (  # noqa: E402
    dcgan,
    wasserstein_gan,
)

OUT = os.path.join(ROOT, "scripts", "gan_jax_reference.json")
Z_DIM = 16


def bright_data(n=512):
    """``tests/test_examples.py``'s CIFAR-shaped data with pixel mean 0.75."""
    rng = np.random.RandomState(0)
    return (0.6 + 0.3 * rng.rand(n, 32, 32, 3)).astype(np.float32)


def _gen_mean(params, seed):
    x = dcgan.generator(params, 256, Z_DIM, jax.random.PRNGKey(seed))
    return float(jnp.mean(x["x_gen"]))


def _with_key(module, seed):
    """``module.jax`` with ``random.PRNGKey(1234)`` giving ``PRNGKey(seed)``."""
    rnd = types.SimpleNamespace(**{k: getattr(jax.random, k)
                                   for k in dir(jax.random)
                                   if not k.startswith("_")})
    rnd.PRNGKey = lambda s: jax.random.PRNGKey(seed if s == 1234 else s)
    return types.SimpleNamespace(jit=jax.jit, nn=jax.nn, random=rnd,
                                 tree=jax.tree, value_and_grad=jax.value_and_grad)


def one(seed, data):
    dm = float(data.mean())
    _, kg, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    init_gen = dcgan.init_gen_params(kg, Z_DIM, ngf=8)
    out = {"seed": seed}
    saved = dcgan.jax, wasserstein_gan.jax
    dcgan.jax = wasserstein_gan.jax = _with_key(dcgan, seed)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            gen_p, disc_p, _ = dcgan.main(
                epochs=8, batch_size=32, z_dim=Z_DIM, ngf=8, ndf=4, lr=1e-3,
                x_train=data, iters_per_epoch=16, save_samples=False)
            wgen_p, _, whist = wasserstein_gan.main(
                epochs=5, batch_size=32, z_dim=Z_DIM, n_critic=2, ngf=8,
                ndf=4, lr=1e-3, x_train=data, iters_per_epoch=12)
    finally:
        dcgan.jax, wasserstein_gan.jax = saved
    gap0 = abs(_gen_mean(init_gen, 5) - dm)
    out["dcgan_gap_ratio"] = abs(_gen_mean(gen_p, 6) - dm) / gap0
    fakes = dcgan.generator(gen_p, 256, Z_DIM, jax.random.PRNGKey(9))["x_gen"]
    r = np.asarray(dcgan.discriminator(disc_p, jnp.asarray(data[:256]))) > 0
    f = np.asarray(dcgan.discriminator(disc_p, fakes)) < 0
    out["dcgan_disc_accuracy"] = float(0.5 * (r.mean() + f.mean()))
    out["wgan_gap_ratio"] = (abs(_gen_mean(wgen_p, 7) - dm)
                             / abs(_gen_mean(init_gen, 7) - dm))
    out["wgan_w_dist_finite"] = bool(np.all(np.isfinite(whist["w_dist"])))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--seeds", type=int, default=8)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    data = bright_data()
    t0 = time.perf_counter()
    runs = [one(1234 + i, data) for i in range(args.seeds)]
    rec = {"script": "scripts/gan_jax_reference.py", "jax": jax.__version__,
           "device": "cpu", "runs": runs,
           "median": {k: float(np.median([r[k] for r in runs]))
                      for k in ("dcgan_gap_ratio", "dcgan_disc_accuracy",
                                "wgan_gap_ratio")},
           "seconds": time.perf_counter() - t0}
    rec["commit"] = subprocess.run(["git", "rev-parse", "HEAD"],
                                   capture_output=True, text=True,
                                   cwd=ROOT).stdout.strip()
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
        fh.write("\n")
    print(json.dumps(rec["median"]))


if __name__ == "__main__":
    main()
