"""Predictive model comparison with PSIS-LOO and WAIC.

Port of ``examples/model_comparison/loo_compare.py`` (beyond the
reference's zoo): three polynomial regressions (degrees 0, 1, 2; noise
0.3) fitted by adaptive HMC (32 chains, 500 iterations, the first 250
adapting the step size) on 40 points from the degree-1 truth, then scored
by the expected log predictive density (Vehtari, Gelman & Gabry 2017) of
the 8000 kept draws: degree 0 loses decisively, degrees 1 and 2 tie within
error, and every ``pareto_k`` stays below 0.7.

HMC fits each regression on its built-in density
(:class:`~zhusuan_tpu_torch.ops.densities.GaussianLinearRegressionLogJoint`,
held against the model once at the chains' first state), so on the card
each iteration is one launch of the HMC kernel, as the JAX package traces
the model into its Pallas kernel on a TPU; the scores come from the model.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.model_comparison.loo_compare
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.evaluation import (
    compare,
    pointwise_log_likelihood,
    psis_loo,
    waic,
)
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import HMC
from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.ops.densities import (
    GaussianLinearRegressionLogJoint,
    check_builtin_gaps,
)

__all__ = ["NOISE", "make_design", "make_model", "make_data",
           "regression_builtin", "check_builtin", "fit_and_score", "main"]

NOISE = 0.3


def make_design(x, degree):
    """``[n, degree+1]`` polynomial design matrix (1, x, x^2, ...)."""
    return np.stack([x ** d for d in range(degree + 1)], axis=1)


def make_model(X, y_group_ndims, dtype=torch.float32, device=None):
    """The polynomial model at two likelihood granularities:
    ``y_group_ndims=1`` sums over the data axis (the chain-shaped
    log-joint HMC needs), ``0`` keeps a column a data point (what
    ``pointwise_log_likelihood`` reads)."""
    X_t = torch.as_tensor(X, dtype=dtype, device=device)

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        w = bn.normal("w", torch.zeros(X_t.shape[1], dtype=dtype,
                                       device=device), std=1.0,
                      group_ndims=1)
        bn.normal("y", w.tensor @ X_t.T, std=NOISE,
                  group_ndims=y_group_ndims)
        return bn

    return model()


def regression_builtin(X, y):
    """The model of :func:`make_model` as a built-in density over ``w``
    (its data held, normalising constants included)."""
    return GaussianLinearRegressionLogJoint("w", X, y, 1.0, NOISE)


def check_builtin(builtin, X, y, w):
    """Hold ``builtin`` against the model's log joint at ``w [n, d]`` (one
    read of the device); raises where they differ."""
    model = make_log_joint_fn(
        make_model(X, 1, w.dtype, w.device),
        {"y": torch.as_tensor(y, dtype=w.dtype, device=w.device)})
    check_builtin_gaps([("the regression built-in", builtin({"w": w}),
                         model({"w": w}))], "chains' first state",
                       equal=True)


def make_data(n_data=40, seed=0):
    """``(x, y)``: 40 points of ``0.3 + 1.2 x`` plus noise 0.3."""
    rng = np.random.RandomState(seed)
    x = np.linspace(-1.0, 1.0, n_data)
    y = make_design(x, 1) @ np.array([0.3, 1.2]) + NOISE * rng.randn(n_data)
    return x, y


def fit_and_score(X, y, key, n_chains=32, n_iters=500, n_adapt=250,
                  dtype=torch.float32, device=None):
    """HMC-fit the polynomial model; returns ``(LOOResult, WAICResult,
    draws [n_iters - n_adapt, n_chains, d])``.

    :param key: the sampler's key (a ``torch.Generator`` or a pair).
    """
    observed = {"y": torch.as_tensor(y, dtype=dtype, device=device)}
    builtin = regression_builtin(X, y)
    hmc = HMC(step_size=0.1, n_leapfrogs=10, adapt_step_size=True)
    state = hmc.init({"w": torch.zeros(n_chains, X.shape[1], dtype=dtype,
                                       device=device)}, n_chain_dims=1)
    check_builtin(builtin, X, y, state.q["w"])
    _, out = hmc.run(builtin, {}, state, key, n_iters=n_iters,
                     n_adapt=n_adapt, collect_fields=("samples",))
    draws = out["samples"]["w"][n_adapt:]
    ll = pointwise_log_likelihood(make_model(X, 0, dtype, device),
                                  {"w": draws.reshape(-1, X.shape[1])},
                                  observed, node="y")
    return psis_loo(ll), waic(ll), draws


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_data", default=40, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--n_chains", default=32, type=int)
    parser.add_argument("--n_iters", default=500, type=int)
    parser.add_argument("--n_adapt", default=250, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    x, y = make_data(hps.n_data, hps.seed)
    generator = torch.Generator().manual_seed(3)
    results = {}
    for degree in (0, 1, 2):
        loo, wc, _ = fit_and_score(make_design(x, degree), y, generator,
                                   hps.n_chains, hps.n_iters, hps.n_adapt,
                                   device=device)
        results[degree] = loo
        print("degree {}: elpd_loo = {:8.2f} +- {:.2f}  p_loo = {:.2f}  "
              "max k = {:.2f}   (waic {:8.2f})".format(
                  degree, float(loo.elpd_loo), float(loo.se),
                  float(loo.p_loo), float(loo.pareto_k.max()),
                  float(wc.elpd_waic)))
    gap01 = float(results[1].elpd_loo - results[0].elpd_loo)
    gap12 = float(results[1].elpd_loo - results[2].elpd_loo)
    print("elpd(deg1) - elpd(deg0) = {:+.2f}  -> degree 0 decisively "
          "worse".format(gap01))
    print("elpd(deg1) - elpd(deg2) = {:+.2f}  -> tie within error "
          "(nested models)".format(gap12))
    print("\nranked (paired-difference SEs):")
    rows = compare({"degree {}".format(d): r for d, r in results.items()})
    for row in rows:
        print("  #{} {:9s} elpd {:8.2f}  diff {:6.2f} +- {:.2f}{}".format(
            row.rank, row.name, row.elpd, row.elpd_diff, row.dse,
            "  [k>0.7!]" if row.warning else ""))
    return results, rows


if __name__ == "__main__":
    main()
