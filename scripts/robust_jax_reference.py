"""The JAX package's numbers for ``chip_smoke.py`` phase 35's examples,
written to ``scripts/robust_jax_reference.json``.

Runs, on the CPU at the JAX examples' defaults:

- ``robust_models/ordinal_regression.py`` (n 400, 32 chains, 1200
  iterations, 400 burn-in, seed 1) and ``survival_regression.py`` (n 500,
  16 chains, 1200, 400, seed 4): their synthetic data (``make_data``'s
  ``jax.random`` draws, which the port's ``run(data=...)`` takes) and the
  posterior means and sds;
- ``hierarchical/eight_schools.py``: ``funnel_diagnosis``'s three rates
  (32 chains, 1000 iterations, 500 adaptation), ``main``'s posterior means
  (64 chains, 3000, 1500) and the (mu, tau) quadrature means of
  ``tests/test_examples.py``;
- ``robust_models/robust_regression.py`` ``main`` (64 x 1500, 700) and
  ``mixture_models/gmm.py`` ``main`` (16 x 1500, 800): their posterior
  summaries.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/robust_jax_reference.py
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

from examples.hierarchical import eight_schools  # noqa: E402
from examples.mixture_models import gmm  # noqa: E402
from examples.robust_models import (  # noqa: E402
    ordinal_regression,
    robust_regression,
    survival_regression,
)

OUT = os.path.join(ROOT, "scripts", "robust_jax_reference.json")


def quadrature():
    """``tests/test_examples.py``'s (mu, tau) quadrature posterior means of
    eight schools, theta integrated out."""
    mus = np.linspace(-20, 35, 400)
    taus = np.linspace(0.01, 40, 800)
    m, t = np.meshgrid(mus, taus, indexing="ij")
    lp = -0.5 * (m / 100.0) ** 2 + np.log(1 / (1 + (t / 5.0) ** 2))
    for y, s in zip(eight_schools.Y, eight_schools.SIGMA):
        v = s ** 2 + t ** 2
        lp += -0.5 * np.log(v) - 0.5 * (y - m) ** 2 / v
    w = np.exp(lp - lp.max())
    w /= w.sum()
    return float((m * w).sum()), float((t * w).sum())


def _list(v):
    return [float(x) for x in np.asarray(v).ravel()]


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    seconds = {}
    rec = {"script": "scripts/robust_jax_reference.py",
           "jax": jax.__version__, "device": "cpu"}

    o = {"n": 400, "n_chains": 32, "n_iters": 1200, "burnin": 400,
         "seed": 1}
    x, y, _ = ordinal_regression.make_data(o["n"],
                                           jax.random.PRNGKey(o["seed"]))
    res, seconds["ordinal"] = _timed(ordinal_regression.run, **o)
    rec["ordinal"] = {
        "recipe": o, "dtype": str(np.asarray(x).dtype),
        "x": np.asarray(x, np.float64).tolist(),
        "y": [int(v) for v in np.asarray(y)],
        **{k: _list(res[k]) for k in ("beta_mean", "beta_sd", "cuts_mean",
                                      "cuts_sd")}}

    s = {"n": 500, "n_chains": 16, "n_iters": 1200, "burnin": 400,
         "seed": 4}
    x, yy, c, frac, _ = survival_regression.make_data(
        s["n"], jax.random.PRNGKey(s["seed"]))
    res, seconds["survival"] = _timed(survival_regression.run, **s)
    rec["survival"] = {
        "recipe": s, "dtype": str(np.asarray(yy).dtype),
        "x": np.asarray(x, np.float64).tolist(), "y": _list(yy),
        "c": _list(c), "frac_censored": frac,
        "k_mean": res["k_mean"], "k_sd": res["k_sd"],
        "beta_mean": _list(res["beta_mean"]),
        "beta_sd": _list(res["beta_sd"])}

    f = {"n_chains": 32, "n_iters": 1000, "n_adapt": 500}
    (c_rate, nc_rate, small), seconds["funnel"] = _timed(
        eight_schools.funnel_diagnosis, verbose=False, **f)
    mu_q, tau_q = quadrature()
    e = {"n_chains": 64, "n_iters": 3000, "n_adapt": 1500}
    (stats, theta), seconds["eight_schools"] = _timed(
        eight_schools.main, verbose=False, **e)
    rec["eight_schools"] = {
        "funnel_recipe": f, "c_rate": c_rate, "nc_rate": nc_rate,
        "small_frac": small, "quadrature": {"mu": mu_q, "tau": tau_q},
        "main_recipe": e, "mu_mean": float(stats["mu"]["mean"]),
        "tau_mean": float(stats["tau"]["mean"]),
        "theta_mean": _list(np.asarray(theta).reshape(-1, 8).mean(0))}

    r = {"n_chains": 64, "n_iters": 1500, "n_adapt": 700}
    (slope, ols), seconds["robust"] = _timed(robust_regression.main, **r)
    rec["robust_regression"] = {"recipe": r, "slope": slope, "ols": ols}

    g = {"n_chains": 16, "n_iters": 1500, "n_adapt": 800}
    ((w, mu, sd), acc, _), seconds["gmm"] = _timed(gmm.main, verbose=False,
                                                   **g)
    rec["gmm"] = {"recipe": g, "w": _list(w), "mu": _list(mu),
                  "sd": _list(sd), "accuracy": acc}

    rec["seconds"] = seconds
    rec["commit"] = subprocess.run(["git", "rev-parse", "HEAD"],
                                   capture_output=True, text=True,
                                   cwd=ROOT).stdout.strip()
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
        fh.write("\n")
    print(json.dumps({k: v for k, v in rec.items()
                      if k in ("seconds",)}))


if __name__ == "__main__":
    main()
