"""Stochastic volatility by particle filtering and PMMH.

Port of ``examples/state_space/stochastic_volatility.py``: the canonical
nonlinear, non-Gaussian state-space model (Kim, Shephard & Chib 1998) on
:mod:`zhusuan_tpu_torch.ssm`:

.. math::
    h_0 \\sim N(\\mu, \\sigma^2/(1-\\phi^2)), \\quad
    h_t = \\mu + \\phi (h_{t-1} - \\mu) + \\sigma \\eta_t, \\quad
    y_t = \\exp(h_t / 2)\\, \\epsilon_t.

The emission is non-Gaussian in the state, so the Kalman filter does not
apply: a bootstrap particle filter tracks ``h``, and pseudo-marginal MH
infers ``(mu, phi, sigma)``, with phi and sigma proposed on unconstrained
scales (arctanh / log). The chains' filters run as one vmapped batch.
Synthetic returns from known parameters (flagged ``synthetic``), in
float64.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.state_space.stochastic_volatility
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.ssm import ParticleFilter, PseudoMarginalMH

__all__ = ["TRUE", "simulate", "make_filter", "log_prior", "run_pmmh",
           "main"]

TRUE = {"mu": -1.0, "phi": 0.95, "sigma": 0.25}


def simulate(T, seed=0):
    """Synthetic log-volatility path + returns (flagged synthetic)."""
    rng = np.random.default_rng(seed)
    mu, phi, sigma = TRUE["mu"], TRUE["phi"], TRUE["sigma"]
    h = mu + sigma / np.sqrt(1.0 - phi ** 2) * rng.standard_normal()
    hs, ys = [], []
    for _ in range(T):
        hs.append(h)
        ys.append(np.exp(h / 2.0) * rng.standard_normal())
        h = mu + phi * (h - mu) + sigma * rng.standard_normal()
    return np.array(hs), np.array(ys), True  # synthetic=True


def make_filter(theta, ys, n_particles):
    """Bootstrap filter for one (mu, arctanh-phi, log-sigma) setting
    (0-d tensors; under PMMH's vmap, one chain's)."""
    mu = theta["mu"]
    phi = torch.tanh(theta["phi_u"])
    sigma = torch.exp(theta["log_sigma"])

    def init_fn(gen, n):
        scale = sigma / torch.sqrt(1.0 - phi ** 2)
        return mu + scale * torch.randn(n, generator=gen, dtype=mu.dtype,
                                        device=mu.device)

    def transition_fn(gen, h, t):
        return (mu + phi * (h - mu) + sigma * torch.randn(
            h.shape, generator=gen, dtype=h.dtype, device=h.device))

    def emission_log_prob(h, y, t):
        # y_t | h_t ~ N(0, exp(h_t))
        return (-0.5 * y ** 2 * torch.exp(-h) - 0.5 * h
                - 0.5 * math.log(2.0 * math.pi))

    return ParticleFilter(init_fn, transition_fn, emission_log_prob,
                          n_particles=n_particles)


def log_prior(theta):
    """mu ~ N(0, 2^2); phi_u ~ N(2, 1) (mass near persistence);
    log_sigma ~ N(-1.5, 1)."""
    return (-0.5 * (theta["mu"] / 2.0) ** 2
            - 0.5 * (theta["phi_u"] - 2.0) ** 2
            - 0.5 * (theta["log_sigma"] + 1.5) ** 2)


def run_pmmh(ys, n_particles=512, n_chains=8, n_iters=1500, seed=0,
             device=None):
    """PMMH over ``(mu, phi_u, log_sigma)`` from a spread of ``mu`` starts;
    ``device`` the returns' when they are a tensor, else the card."""
    if device is None:
        device = ys.device if isinstance(ys, torch.Tensor) else "cuda:0"
    ys = torch.as_tensor(ys, dtype=torch.float64).to(device)

    def log_z_fn(theta, key):
        return make_filter(theta, ys, n_particles).run(key, ys).log_z

    kern = PseudoMarginalMH(
        log_z_fn, log_prior, step_size=0.08,
        proposal_scales={"mu": 2.0, "phi_u": 1.0, "log_sigma": 1.0})
    spread = torch.randn(n_chains, generator=torch.Generator().manual_seed(
        seed), dtype=torch.float64).to(device)
    state = kern.init({
        "mu": -1.0 + 0.5 * spread,
        "phi_u": torch.full_like(spread, 1.5),
        "log_sigma": torch.full_like(spread, -1.4),
    })
    return kern.run(state, (seed, 1), n_iters)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--t", type=int, default=200, help="series length")
    parser.add_argument("--n-particles", type=int, default=512)
    parser.add_argument("--n-chains", type=int, default=8)
    parser.add_argument("--n-iters", type=int, default=1500)
    parser.add_argument("--burnin", type=int, default=300)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    hs_true, ys, synthetic = simulate(hps.t)
    print("synthetic={} T={}".format(synthetic, len(ys)))
    ys = torch.tensor(ys, dtype=torch.float64, device=device)

    # Filtering at the TRUE parameters: posterior-mean volatility path.
    theta_true = {k: torch.tensor(v, dtype=torch.float64, device=device)
                  for k, v in (("mu", TRUE["mu"]),
                               ("phi_u", np.arctanh(TRUE["phi"])),
                               ("log_sigma", np.log(TRUE["sigma"])))}
    res = make_filter(theta_true, ys, hps.n_particles).run((1, 0), ys)
    rmse = float(torch.sqrt(torch.mean(
        (res.filter_means - torch.as_tensor(hs_true, device=device)) ** 2)))
    print("filter log_z={:.2f} rmse(h)={:.3f} resamples={}".format(
        float(res.log_z), rmse, int(res.n_resamples)))

    _, out = run_pmmh(ys, hps.n_particles, hps.n_chains, hps.n_iters)
    draws = {k: v[hps.burnin:].cpu().numpy()
             for k, v in out["samples"].items()}
    mu_hat = draws["mu"].mean()
    phi_hat = np.tanh(draws["phi_u"]).mean()
    sigma_hat = np.exp(draws["log_sigma"]).mean()
    acc = float(out["acceptance_rate"].mean())
    print("PMMH acc={:.2f} mu={:.2f} phi={:.3f} sigma={:.3f} "
          "(true {:.2f}/{:.2f}/{:.2f})".format(
              acc, mu_hat, phi_hat, sigma_hat,
              TRUE["mu"], TRUE["phi"], TRUE["sigma"]))
    return {"mu": mu_hat, "phi": phi_hat, "sigma": sigma_hat, "acc": acc,
            "rmse": rmse}


if __name__ == "__main__":
    main()
