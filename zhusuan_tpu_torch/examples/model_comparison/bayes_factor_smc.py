"""Bayesian model comparison by SMC evidence estimates.

Port of ``examples/model_comparison/bayes_factor_smc.py``: adaptive-tempered
:class:`~zhusuan_tpu_torch.smc.AnnealedSMC` (MALA rejuvenation) estimates
``log Z`` of two Gaussian linear regressions, degrees 1 and 2, whose true
evidence is closed-form (``y ~ N(0, X X^T + noise^2 I)``): the example
prints each estimate beside its truth. On data from the linear model the
quadratic model's extra parameter dilutes its prior predictive mass, so
its evidence loses (Occam's razor).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.model_comparison.bayes_factor_smc
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import MALA
from zhusuan_tpu_torch.smc import AnnealedSMC

__all__ = ["NOISE", "make_design", "true_log_evidence", "smc_log_evidence",
           "main"]

NOISE = 0.3


def make_design(x, degree):
    """[n, degree+1] polynomial design matrix (1, x, x^2, ...)."""
    return np.stack([x ** d for d in range(degree + 1)], axis=1)


def true_log_evidence(X, y, noise=NOISE):
    """Closed-form log N(y; 0, X X^T + noise^2 I) under w ~ N(0, I)."""
    n = len(y)
    cov = X @ X.T + noise ** 2 * np.eye(n)
    _, logdet = np.linalg.slogdet(cov)
    quad = float(y @ np.linalg.solve(cov, y))
    return -0.5 * (n * math.log(2 * math.pi) + logdet + quad)


def smc_log_evidence(X, y, key, n_particles=4000, noise=NOISE, device=None):
    """``(log Z estimate, temperatures used)`` of one regression by
    ``run_adaptive(target_cess=0.9)`` in float64 on ``device`` (the card by
    default); ``key`` a ``torch.Generator`` or a Philox key pair."""
    device = torch.device("cuda:0" if device is None else device)
    d = X.shape[1]
    X_t = torch.as_tensor(X, dtype=torch.float64, device=device)
    y_t = torch.as_tensor(y, dtype=torch.float64, device=device)
    one = torch.ones((), dtype=torch.float64, device=device)

    @meta_bayesian_net()
    def proposal():
        bn = BayesianNet()
        bn.normal("w", torch.zeros((n_particles, d), dtype=torch.float64,
                                   device=device), std=one, group_ndims=1)
        return bn

    def log_joint(obs):
        w = obs["w"]  # [n_particles, d]
        log_prior = torch.sum(-0.5 * w ** 2 - 0.5 * math.log(2 * math.pi),
                              dim=-1)
        resid = y_t - w @ X_t.T
        log_lik = torch.sum(-0.5 * (resid / noise) ** 2 - math.log(noise)
                            - 0.5 * math.log(2 * math.pi), dim=-1)
        return log_prior + log_lik

    smc = AnnealedSMC(log_joint, proposal(), MALA(step_size=0.1),
                      observed={}, latent=["w"], n_moves=3)
    res = smc.run_adaptive(key, target_cess=0.9)
    return float(res.log_z), int(res.n_steps)


def main(n_data=30, seed=0, n_particles=4000, device=None):
    """Both evidences on data from the linear model; returns ``{degree:
    (estimate, truth)}``."""
    rng = np.random.RandomState(seed)
    x = np.linspace(-1.0, 1.0, n_data)
    w_true = np.array([0.3, 1.2])
    y = make_design(x, 1) @ w_true + NOISE * rng.randn(n_data)
    results = {}
    for degree in (1, 2):
        X = make_design(x, degree)
        true_lz = true_log_evidence(X, y)
        est_lz, n_steps = smc_log_evidence(X, y, (1, degree),
                                           n_particles=n_particles,
                                           device=device)
        results[degree] = (est_lz, true_lz)
        print("degree {}: SMC log Z = {:.3f} (truth {:.3f}, {} adaptive "
              "temperatures)".format(degree, est_lz, true_lz, n_steps))
    bf = results[1][0] - results[2][0]
    print("log Bayes factor (linear vs quadratic): {:.3f} ({})".format(
        bf, "prefers linear" if bf > 0 else "prefers quadratic"))
    return results


if __name__ == "__main__":
    _parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _parser.add_argument("--n-data", type=int, default=30)
    _parser.add_argument("--seed", type=int, default=0)
    _parser.add_argument("--n-particles", type=int, default=4000)
    add_device_arg(_parser)
    _args = _parser.parse_args()
    main(_args.n_data, _args.seed, _args.n_particles,
         resolve_device(_args.device))
