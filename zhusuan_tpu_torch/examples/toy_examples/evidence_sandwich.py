"""Sandwiching the model evidence: the Renyi bound from below, CUBO from
above.

Port of ``examples/toy_examples/evidence_sandwich.py`` (beyond the
reference, which only lower-bounds log Z): one Normal variational family
fitted twice, maximizing the VR-0.5 lower bound (Li & Turner 2016) and
minimizing the CUBO_2 upper bound through its exponentiated surrogate
(Dieng et al. 2017), each with Adam(5e-2) for 800 steps at 256 particles
from mean -1, log-std 0.7; then both bounds at 100000 particles bracket
``log Z`` of a conjugate target: z ~ N(0, 1), x | z ~ N(z, 1), x0 = 1, so
``log Z = log N(1; 0, sqrt 2)`` and the posterior is N(0.5, sqrt 0.5).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.toy_examples.evidence_sandwich
"""

from __future__ import annotations

import argparse
import math

import torch

from zhusuan_tpu_torch import distributions, variational
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net

__all__ = ["X0", "build_model", "build_variational", "init_params",
           "vr_cost", "cubo_cost", "fit_bound", "main"]

X0 = 1.0


@meta_bayesian_net()
def build_model(n_particles, dtype=torch.float32, device=None):
    """p(z) p(x | z), its scalars in ``dtype`` on ``device`` (float32 weak
    types in the JAX example)."""
    bn = BayesianNet()
    zero = torch.zeros((), dtype=dtype, device=device)
    z = bn.normal("z", zero, std=1.0, n_samples=n_particles)
    bn.normal("x", z.tensor, std=1.0)
    return bn


def build_variational(params, n_particles, key, noise=None):
    """q(z) = N(mean, exp(logstd)); ``noise={"z": eps}`` replaces its
    standard normals (testing hook)."""
    bn = BayesianNet(key=key, noise=noise)
    bn.normal("z", params["mean"], logstd=params["logstd"],
              n_samples=n_particles)
    return bn


def init_params(dtype=torch.float32, device=None):
    """The starting point, mean -1 and log-std 0.7 (leaves that require
    grad)."""
    return {k: torch.tensor(v, dtype=dtype, device=device,
                            requires_grad=True)
            for k, v in (("mean", -1.0), ("logstd", 0.7))}


def _observed(params):
    p = params["mean"]
    return {"x": torch.tensor(X0, dtype=p.dtype, device=p.device)}


def vr_cost(params, n_particles, key, noise=None):
    """The VR-0.5 surrogate cost (``-L_0.5``)."""
    q = build_variational(params, n_particles, key, noise=noise)
    model = build_model(n_particles, params["mean"].dtype,
                        params["mean"].device)
    return variational.vr_objective(model, _observed(params), variational=q,
                                    axis=0, alpha=0.5).sgvb()


def cubo_cost(params, n_particles, key, noise=None):
    """CUBO_2's exponentiated surrogate ``E_q[w^2]`` (shifted)."""
    q = build_variational(params, n_particles, key, noise=noise)
    model = build_model(n_particles, params["mean"].dtype,
                        params["mean"].device)
    return variational.cubo_objective(model, _observed(params),
                                      variational=q, axis=0,
                                      n=2.0).exp_sgvb()


def fit_bound(cost_fn, params, n_iters, n_particles, lr=5e-2, seed=0,
              noise=None):
    """Adam on ``cost_fn(params, n_particles, key, noise)`` for
    ``n_iters`` steps, a key a step drawn from a CPU generator seeded
    ``seed``; ``noise`` (testing hook) is a list of per-step noise dicts.
    Returns the fitted params."""
    optimizer = torch.optim.Adam(list(params.values()), lr=lr)
    keys = draw_keys(torch.Generator().manual_seed(seed), n_iters)
    for i, key in enumerate(keys):
        optimizer.zero_grad(set_to_none=True)
        cost_fn(params, n_particles, key,
                None if noise is None else noise[i]).backward()
        optimizer.step()
    return params


@torch.no_grad()
def _bounds(lo_params, up_params, n_eval):
    k_lo, k_up = draw_keys(torch.Generator().manual_seed(123), 2)
    model = build_model(n_eval, lo_params["mean"].dtype,
                        lo_params["mean"].device)
    lower = variational.vr_objective(
        model, _observed(lo_params),
        variational=build_variational(lo_params, n_eval, k_lo), axis=0,
        alpha=0.5).tensor
    upper = variational.cubo_objective(
        model, _observed(up_params),
        variational=build_variational(up_params, n_eval, k_up), axis=0,
        n=2.0).tensor
    return float(lower), float(upper)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_iters", default=800, type=int)
    parser.add_argument("--n_particles", default=256, type=int)
    parser.add_argument("--n_eval", default=100_000, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    lo_params = fit_bound(vr_cost, init_params(device=device), hps.n_iters,
                          hps.n_particles)
    up_params = fit_bound(cubo_cost, init_params(device=device), hps.n_iters,
                          hps.n_particles, seed=1)
    lower, upper = _bounds(lo_params, up_params, hps.n_eval)
    log_z = float(distributions.Normal(
        torch.tensor(0.0, dtype=torch.float64),
        std=math.sqrt(2.0)).log_prob(torch.tensor(X0, dtype=torch.float64)))
    print("VR-0.5 lower bound = {:.4f} <= log Z = {:.4f} <= CUBO_2 = {:.4f}"
          .format(lower, log_z, upper))
    print("fitted q (VR): mean={:.3f} std={:.3f}; (CUBO): mean={:.3f} "
          "std={:.3f}; posterior: mean=0.500 std={:.3f}".format(
              *(float(v.detach()) for v in (
                  lo_params["mean"], lo_params["logstd"].exp(),
                  up_params["mean"], up_params["logstd"].exp())),
              math.sqrt(0.5)))
    return {"lower": lower, "upper": upper, "log_z": log_z,
            "gap": upper - lower}


if __name__ == "__main__":
    main()
