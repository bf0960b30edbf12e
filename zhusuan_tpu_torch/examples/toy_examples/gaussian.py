"""Gaussian toy posterior by HMC with 1000 chains in parallel.

Port of ``examples/toy_examples/gaussian.py`` (parity: reference
``examples/toy_examples/gaussian.py``, BASELINE config #1): a 10-dim
diagonal Normal with stds ``1/(i+1)``, 1000 chains, 5 leapfrogs, step size
and mass adapted over the first 50 of 100 burn-in iterations, then 100
sampling iterations.

Two routes to the same transition:

- by default the model is a ``BayesianNet`` with one ``bn.normal`` node,
  and ``HMC`` takes the plain path (``experimental_fused_step=False``);
- ``--fused`` (the JAX package sends this model to its Pallas HMC kernel)
  hands ``HMC`` the built-in density
  ``DiagonalGaussianLogJoint("x", 0, stdev)`` in place of the model: the
  model's exact log-density up to a constant, which the hand-written CUDA
  HMC step evaluates (``csrc/hmc_step.cu``; its kernel takes built-in
  densities only). On the card every iteration is one launch of it
  (``experimental_fused_step=True``: an ineligible input raises); on the
  CPU the plain path runs.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.toy_examples.gaussian [--fused]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import HMC
from zhusuan_tpu_torch.ops.densities import DiagonalGaussianLogJoint

__all__ = ["N_X", "N_CHAINS", "N_ITERS", "BURNIN", "N_LEAPFROGS", "stdev",
           "build_model", "log_joint", "make_hmc", "init_state", "run",
           "main"]

N_X, N_CHAINS, N_ITERS, BURNIN, N_LEAPFROGS = 10, 1000, 200, 100, 5


def stdev(n_x=N_X, dtype=torch.float32, device=None):
    """The target's stds ``1 / (i + 1)`` (computed in float32, as the JAX
    example does, then cast)."""
    s = (1.0 / (np.arange(n_x) + 1)).astype(np.float32)
    return torch.as_tensor(s, device=device).to(dtype)


def build_model(n_chains=N_CHAINS, n_x=N_X, dtype=torch.float32,
                device=None):
    """The model: one ``bn.normal`` node ``x`` of ``[n_chains, n_x]`` with
    mean 0 and :func:`stdev`, its last axis one event (reference
    gaussian.py:27-35)."""
    std = stdev(n_x, dtype, device)

    @meta_bayesian_net()
    def gaussian():
        bn = BayesianNet()
        bn.normal("x", torch.zeros([n_chains, n_x], dtype=dtype,
                                   device=device),
                  std=std, group_ndims=1)
        return bn

    return gaussian()


def log_joint(fused, n_chains=N_CHAINS, n_x=N_X, dtype=torch.float32,
              device=None):
    """What ``HMC`` samples: the built-in density on the ``--fused``
    route, the model otherwise."""
    if fused:
        return DiagonalGaussianLogJoint(
            "x", torch.zeros(n_x, dtype=dtype, device=device),
            stdev(n_x, dtype, device))
    return build_model(n_chains, n_x, dtype, device)


def make_hmc(fused):
    """The example's sampler (reference gaussian.py:37-44)."""
    return HMC(step_size=1e-3, n_leapfrogs=N_LEAPFROGS, adapt_step_size=True,
               adapt_mass=True, target_acceptance_rate=0.9,
               experimental_fused_step=bool(fused))


def init_state(hmc, n_chains=N_CHAINS, n_x=N_X, dtype=torch.float32,
               device=None):
    return hmc.init({"x": torch.zeros([n_chains, n_x], dtype=dtype,
                                      device=device)}, n_chain_dims=1)


def run(device, fused, n_chains=N_CHAINS, n_x=N_X, n_iters=N_ITERS,
        burnin=BURNIN, dtype=torch.float32):
    """Burn-in (adaptation on for its first half), then ``n_iters -
    burnin`` sampling iterations; returns the sampling run's outputs and
    the relative error of each dimension's pooled std."""
    device = torch.device(device)
    target = log_joint(fused, n_chains, n_x, dtype, device)
    hmc = make_hmc(fused)
    state = init_state(hmc, n_chains, n_x, dtype, device)
    state, _ = hmc.run(target, {}, state,
                       torch.Generator().manual_seed(1), burnin,
                       n_adapt=burnin // 2, collect=False)
    state, out = hmc.run(target, {}, state,
                         torch.Generator().manual_seed(2),
                         n_iters - burnin)
    samples = out["samples"]["x"].reshape(-1, n_x).double()
    std = stdev(n_x, torch.float64, device)
    rel_err = (samples.std(0, unbiased=False) - std).abs() / std
    return state, out, rel_err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fused", action="store_true",
                        help="send every transition to the CUDA HMC step "
                             "kernel through the built-in density")
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    print("Sampling...")
    _, out, rel_err = run(device, hps.fused)
    print("Finished.")
    samples = out["samples"]["x"].reshape(-1, N_X).double()
    print("Acceptance rate (mean):", float(out["acceptance_rate"].mean()))
    print("Sample mean:", samples.mean(0).cpu().numpy())
    print("Sample stdev:", samples.std(0, unbiased=False).cpu().numpy())
    print("True stdev:", stdev().numpy())
    print("Relative error of stdev:", rel_err.cpu().numpy())
    return rel_err


if __name__ == "__main__":
    main()
