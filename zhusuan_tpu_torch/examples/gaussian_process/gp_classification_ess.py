"""GP binary classification by elliptical slice sampling.

Port of ``examples/gaussian_process/gp_classification_ess.py``: MCMC over
the GP latent function with :class:`~zhusuan_tpu_torch.mcmc.EllipticalSlice`
(the prior covariance as a Cholesky factor, a logit link, no tuning
parameter) on 60 1-D points of two noisy bands. The Gram matrix is built
and factored on the host in float64, as in the JAX file (the float32 RBF
Gram at this lengthscale is not numerically positive definite).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.gaussian_process.gp_classification_ess
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import EllipticalSlice

__all__ = ["make_data", "prior_chol", "make_log_lik", "run", "main"]


def make_data(n=60, seed=0):
    """1-D two-band labels in {-1, 1} with a few stochastic flips."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(-1.0, 1.0, n)).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-4.0 * np.sin(3.0 * x)))
    y = np.where(rng.rand(n) < p, 1.0, -1.0)
    return x, y


def prior_chol(x):
    """Cholesky factor of the RBF Gram (lengthscale^2 0.09, the form of
    ``examples/gaussian_process/utils.RBFKernel``) plus 1e-8 I, float64 on
    the host."""
    sq = (x[:, None] - x[None, :]) ** 2
    k_mat = np.exp(-0.5 * sq / 0.09) + 1e-8 * np.eye(len(x))
    return np.linalg.cholesky(k_mat)


def make_log_lik(y, scale, dtype, device):
    """``log L(f) = sum log sigmoid(scale y f)`` over the last axis."""
    y_t = torch.as_tensor(y, dtype=dtype, device=device)

    def log_lik(obs):
        return torch.sum(F.logsigmoid(scale * y_t * obs["f"]), dim=-1)

    return log_lik


def run(device, n_chains=64, n_iters=2000, burn_in=800, scale=3.0,
        dtype=torch.float32, seed=1, noise=None):
    """The sampler's run and the posterior-mean classifier's training
    accuracy: ``(acc, base, out)`` with ``base`` the majority class's
    share and ``out`` the run's outputs. ``noise``: the sampler's testing
    hook (one tuple an iteration)."""
    device = torch.device(device)
    x, y = make_data()
    chol = torch.as_tensor(prior_chol(x), dtype=dtype, device=device)
    ess = EllipticalSlice(prior_chol={"f": chol})
    state = ess.init({"f": torch.zeros((n_chains, len(x)), dtype=dtype,
                                       device=device)}, n_chain_dims=1)
    gen = torch.Generator(device=device).manual_seed(seed)
    _, out = ess.run(make_log_lik(y, scale, dtype, device), {}, state, gen,
                     n_iters, noise=noise)
    f = out["samples"]["f"][burn_in:].reshape(-1, len(x))
    f = f.double().cpu().numpy()
    p_pred = 1.0 / (1.0 + np.exp(-scale * f))  # per-draw probabilities
    p_mean = p_pred.mean(axis=0)
    acc = float(((p_mean > 0.5) == (y > 0)).mean())
    base = float(max((y > 0).mean(), (y < 0).mean()))
    return acc, base, out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_chains", default=64, type=int)
    parser.add_argument("--n_iters", default=2000, type=int)
    parser.add_argument("--burn_in", default=800, type=int)
    parser.add_argument("--scale", default=3.0, type=float)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    acc, base, out = run(resolve_device(hps.device), hps.n_chains,
                         hps.n_iters, hps.burn_in, hps.scale)
    print("GP-ESS classification: train acc {:.3f} (majority baseline "
          "{:.3f}); mean shrink steps {:.1f}".format(
              acc, base, float(out["n_shrinks"].double().mean())))
    return acc, base


if __name__ == "__main__":
    main()
