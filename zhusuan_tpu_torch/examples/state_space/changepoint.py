"""Poisson change-point detection by compound Gibbs sampling.

Port of ``examples/state_space/changepoint.py``: the change point is one
:class:`~zhusuan_tpu_torch.mcmc.DiscreteGibbs` site and the two Poisson
log-rates one :class:`~zhusuan_tpu_torch.mcmc.HMC` block, composed by
:class:`~zhusuan_tpu_torch.mcmc.Gibbs`:

.. math::
    \\tau \\sim \\mathrm{Uniform}\\{1..T-1\\},\\quad
    \\log\\lambda_k \\sim N(0, 2^2),\\quad
    y_t \\sim \\mathrm{Poisson}(\\lambda_1\\,[t<\\tau] +
                                \\lambda_2\\,[t\\ge\\tau]).

The discrete update enumerates all T-1 candidate change points exactly in
one batched density call a sweep. The log joint is the built-in
:class:`~zhusuan_tpu_torch.ops.densities.PoissonChangepointLogJoint`,
which reads the change point per chain from the HMC block's observations:
on the card the block is one launch of the HMC kernel a sweep, as the JAX
package traces the closure into its Pallas kernel on a TPU. On the card
the counts and chains are float32 (the JAX example runs without x64), on
the CPU float64. Synthetic counts from known parameters (flagged
``synthetic``), drawn from torch's Poisson sampler; ``run(y=...)`` takes given counts
instead (e.g. the JAX example's, from
``scripts/changepoint_jax_reference.json``).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.state_space.changepoint
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import HMC, DiscreteGibbs, Gibbs
from zhusuan_tpu_torch.ops.densities import PoissonChangepointLogJoint

__all__ = ["TRUE", "make_data", "build_log_joint", "run", "main"]

TRUE = {"tau": 24, "lam1": 3.0, "lam2": 0.8}


def make_data(t, generator, device=None):
    """Synthetic Poisson counts with a rate drop at ``TRUE['tau']``:
    ``(counts [t] float64, synthetic)``."""
    rates = np.where(np.arange(t) < TRUE["tau"], TRUE["lam1"], TRUE["lam2"])
    y = torch.poisson(torch.tensor(rates), generator=generator)
    return y.to(device), True


def build_log_joint(y):
    """The log joint over ``{"tau": [..., 1], "log_lam": [..., 2]}`` as the
    built-in (``log_lam ~ N(0, 2^2)``, the piecewise Poisson rate; ``tau``
    a value in {1..T-1}, so the indicator is data, not a shape)."""
    return PoissonChangepointLogJoint(y, prior_std=2.0)


def run(t=60, n_chains=64, n_iters=2000, burnin=500, seed=0, y=None,
        device=None):
    """The compound sampler from ``tau = t // 2``, ``log_lam = 0``:
    ``n_iters`` sweeps, the first ``burnin`` adapting HMC's step size and
    dropped.

    :param y: optional ``[t]`` counts (taken as they are; ``t`` then
        follows them); else synthetic counts from ``seed``.
    :param device: the device (the counts' when ``y`` is a tensor, else
        the card); the counts and chains are float32 on the card, float64
        on the CPU.
    """
    if device is None:
        device = y.device if isinstance(y, torch.Tensor) else "cuda:0"
    device = torch.device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    if y is None:
        y, synthetic = make_data(t, torch.Generator().manual_seed(seed),
                                 device)
    else:
        y, synthetic = torch.as_tensor(y, dtype=torch.float64), False
    y = y.to(device=device, dtype=dtype)
    t = y.shape[0]
    log_joint = build_log_joint(y)
    sampler = Gibbs([
        (DiscreteGibbs({"tau": torch.arange(1, t, dtype=y.dtype)}), ["tau"]),
        (HMC(step_size=0.1, n_leapfrogs=6, adapt_step_size=True),
         ["log_lam"]),
    ])
    state = sampler.init(
        {"tau": torch.full((n_chains, 1), float(t // 2), dtype=y.dtype,
                           device=device),
         "log_lam": torch.zeros((n_chains, 2), dtype=y.dtype,
                                device=device)},
        n_chain_dims=1)
    state, out = sampler.run(log_joint, {}, state, (seed, 1), n_iters,
                             n_adapt=burnin)
    tau = out["samples"]["tau"][burnin:].reshape(-1).cpu().numpy()
    lam = torch.exp(out["samples"]["log_lam"][burnin:]).reshape(
        -1, 2).cpu().numpy()
    return {
        "synthetic": synthetic,
        "tau_mode": int(np.bincount(tau.astype(np.int64)).argmax()),
        "tau_mean": float(tau.mean()),
        "lam_mean": lam.mean(0),
        "tau_draws": tau,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--t", type=int, default=60, help="series length")
    parser.add_argument("--n-chains", type=int, default=64)
    parser.add_argument("--n-iters", type=int, default=2000)
    parser.add_argument("--burnin", type=int, default=500)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    res = run(args.t, args.n_chains, args.n_iters, args.burnin,
              device=resolve_device(args.device))
    print(
        "changepoint: tau_mode={} (true {}), tau_mean={:.1f}, "
        "lambda=({:.2f}, {:.2f}) (true ({}, {}))".format(
            res["tau_mode"], TRUE["tau"], res["tau_mean"],
            res["lam_mean"][0], res["lam_mean"][1],
            TRUE["lam1"], TRUE["lam2"]))
    return res


if __name__ == "__main__":
    main()
