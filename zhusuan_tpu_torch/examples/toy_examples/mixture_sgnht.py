"""Bimodal Gaussian mixture sampled by SGNHT.

Port of ``examples/toy_examples/mixture_sgnht.py`` (parity: reference
``examples/toy_examples/mixture_sgnht.py``): modes N(-1, 0.5) and N(3, 0.5)
of equal weight; SGNHT with one scalar auto-tuned friction (lr 0.2,
variance_extra 0.1, tune_rate 0.01, first order) over 1000 chains started
uniformly in [-5, 5]; two thirds of the iterations burn in, then every
100th is kept.

The scalar thermostat couples every chain (``mean(v^2)`` over all of
them) and the mixture is a closure: both keep this sampler on the plain
path (the CUDA SGNHT step runs the vector thermostat on built-in
densities; the JAX package traces the closure into its Pallas kernel).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.toy_examples.mixture_sgnht
"""

from __future__ import annotations

import argparse

import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import SGNHT

__all__ = ["log_joint", "make_sgnht", "run", "main"]

STDEV, MU1, MU2 = 0.5, -1.0, 3.0


def log_joint(observed):
    """The mixture's log-density (unnormalized), by a stable log-sum-exp
    of the two modes."""
    x = observed["x"]
    a1 = -0.5 * ((x - MU1) / STDEV) ** 2
    a2 = -0.5 * ((x - MU2) / STDEV) ** 2
    amax = torch.maximum(a1, a2)
    return amax + torch.log(torch.exp(a1 - amax) + torch.exp(a2 - amax))


def make_sgnht():
    return SGNHT(learning_rate=0.2, variance_extra=0.1, tune_rate=0.01,
                 second_order=False, use_vector_alpha=False)


def run(device, n_chains=1000, n_iters=30000, dtype=torch.float32, seed=1):
    """Burn-in (two thirds, nothing collected), then every 100th of the
    rest: ``(samples [(n_iters - burnin) // 100, n_chains], state)``."""
    device = torch.device(device)
    sgmcmc = make_sgnht()
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = torch.rand((n_chains,), generator=gen, dtype=dtype,
                    device=device) * 10 - 5
    state = sgmcmc.init({"x": x0}, key=(seed, 0))
    burnin = n_iters * 2 // 3
    state, _ = sgmcmc.run(log_joint, {}, state, (seed, 1), burnin,
                          collect=False)
    state, qs = sgmcmc.run(log_joint, {}, state, (seed, 2),
                           n_iters - burnin, thinning=100)
    return qs["x"], state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_chains", default=1000, type=int)
    parser.add_argument("--n_iters", default=30000, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    print("Sampling...")
    samples, state = run(resolve_device(hps.device), hps.n_chains,
                         hps.n_iters)
    print("Finished. alpha:", float(state.alpha["x"]))
    samples = samples.double().reshape(-1)
    # Both modes should carry about half the mass each.
    frac_right = float((samples > 1.0).double().mean())
    print("Fraction in right mode: {:.3f} (true 0.5)".format(frac_right))
    print("Sample mean: {:.3f} (true 1.0)".format(float(samples.mean())))
    return samples.cpu().numpy()


if __name__ == "__main__":
    main()
