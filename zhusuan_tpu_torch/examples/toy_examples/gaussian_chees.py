"""Ill-conditioned Gaussian by ChEES-HMC (adaptive trajectory lengths).

Port of ``examples/toy_examples/gaussian_chees.py``: a 16-dim diagonal
Normal with stds ``geomspace(0.1, 3.0, 16)``, so the best trajectory length
is long and unknown beforehand; ChEES (Hoffman et al. 2021) learns it from
cross-chain statistics. 512 chains, ``step_size=0.05``,
``trajectory_length=0.3``, 1000 iterations of which the first 500 adapt
and are dropped.

Two routes to the same transition:

- by default the model is a ``BayesianNet`` with one ``bn.normal`` node,
  and ``ChEESHMC`` takes the plain path;
- ``--fused`` (the JAX package sends this model to its Pallas ChEES
  kernel) hands ``ChEESHMC`` the built-in density
  ``DiagonalGaussianLogJoint("x", 0, stdev)``, the model's log-density up
  to a constant, which the hand-written CUDA ChEES step evaluates
  (``csrc/hmc_step.cu``; the kernel takes built-in densities only). On the
  card every iteration is one launch of it (``experimental_fused_step=
  True``: an ineligible input raises); on the CPU the plain path runs.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.toy_examples.gaussian_chees [--fused]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import ChEESHMC
from zhusuan_tpu_torch.ops.densities import DiagonalGaussianLogJoint

__all__ = ["N_X", "N_CHAINS", "N_ITERS", "N_ADAPT", "stdev", "build_model",
           "log_joint", "make_chees", "run", "main"]

N_X, N_CHAINS, N_ITERS, N_ADAPT = 16, 512, 1000, 500


def stdev(dtype=torch.float32, device=None):
    """The target's stds ``geomspace(0.1, 3.0, 16)`` (rounded to float32,
    as the JAX example does, then cast)."""
    s = np.geomspace(0.1, 3.0, N_X).astype(np.float32)
    return torch.as_tensor(s, device=device).to(dtype)


def build_model(n_chains=N_CHAINS, dtype=torch.float32, device=None):
    """One ``bn.normal`` node ``x`` of ``[n_chains, 16]``, mean 0, its last
    axis one event."""
    std = stdev(dtype, device)

    @meta_bayesian_net()
    def gaussian():
        bn = BayesianNet()
        bn.normal("x", torch.zeros([n_chains, N_X], dtype=dtype,
                                   device=device),
                  std=std, group_ndims=1)
        return bn

    return gaussian()


def log_joint(fused, n_chains=N_CHAINS, dtype=torch.float32, device=None):
    """What ``ChEESHMC`` samples: the built-in density on the ``--fused``
    route, the model otherwise."""
    if fused:
        return DiagonalGaussianLogJoint(
            "x", torch.zeros(N_X, dtype=dtype, device=device),
            stdev(dtype, device))
    return build_model(n_chains, dtype, device)


def make_chees(fused):
    return ChEESHMC(step_size=0.05, trajectory_length=0.3,
                    experimental_fused_step=bool(fused))


def run(device, fused, n_chains=N_CHAINS, n_iters=N_ITERS, n_adapt=N_ADAPT,
        dtype=torch.float32, seed=0):
    """``n_iters`` iterations (``n_adapt`` of them adapting) from zeros;
    ``(state, out, rel_err)`` with ``rel_err`` each dimension's
    ``|std / stdev - 1|`` over the kept samples."""
    device = torch.device(device)
    chees = make_chees(fused)
    state = chees.init({"x": torch.zeros([n_chains, N_X], dtype=dtype,
                                         device=device)})
    state, out = chees.run(log_joint(fused, n_chains, dtype, device), {},
                           state, (seed, 0), n_iters, n_adapt=n_adapt)
    keep = out["samples"]["x"][n_adapt:].reshape(-1, N_X).double()
    rel_err = (keep.std(0, unbiased=False)
               / stdev(torch.float64, device) - 1.0).abs()
    return state, out, rel_err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_chains", type=int, default=N_CHAINS)
    parser.add_argument("--n_iters", type=int, default=N_ITERS)
    parser.add_argument("--n_adapt", type=int, default=N_ADAPT)
    parser.add_argument("--fused", action="store_true",
                        help="send every transition to the CUDA ChEES step "
                             "kernel through the built-in density")
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    print("Sampling (ChEES adaptive trajectories)...")
    _, out, rel_err = run(resolve_device(hps.device), hps.fused,
                          hps.n_chains, hps.n_iters, hps.n_adapt)
    keep = out["samples"]["x"][hps.n_adapt:].reshape(-1, N_X).double()
    acc = float(out["acceptance_rate"][hps.n_adapt:].double().mean())
    T = float(out["trajectory_length"][-1])
    mean_L = float(out["n_leapfrogs"][hps.n_adapt:].double().mean())
    print("acceptance {:.3f} | learned T {:.2f} (mean L {:.1f}) | "
          "worst std rel-err {:.3f}".format(acc, T, mean_L,
                                            float(rel_err.max())))
    print("Expected stds:", np.round(stdev().numpy(), 3))
    print("Sampled  stds:", np.round(
        keep.std(0, unbiased=False).cpu().numpy(), 3))
    return float(rel_err.max())


if __name__ == "__main__":
    main()
