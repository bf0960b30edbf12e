"""Robust Bayesian regression: a Student-t likelihood and a HalfCauchy
scale, HMC over bijector-unconstrained coordinates.

Port of ``examples/robust_models/robust_regression.py``. On data with gross
outliers the Student-t posterior slope stays near the truth where ordinary
least squares is dragged away. The sampler holds two latents (``w`` and the
Softplus-unconstrained ``sigma``), so HMC takes its plain transition, as the
JAX package's HMC gate (one latent) sends it to its scan path.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.robust_models.robust_regression
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch import distributions as zd
from zhusuan_tpu_torch.bijectors import Softplus, transform_log_joint
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import HMC

__all__ = ["make_data", "make_log_joint", "make_sampler", "main"]


def make_data(n=40, slope=2.0, noise=0.3, outlier=4.0, seed=0):
    """``(x [n], y [n])`` numpy float64: a line with Gaussian noise and a
    gross positive outlier every ninth point (the JAX example's
    ``RandomState`` draws)."""
    rng = np.random.RandomState(seed)
    x = np.linspace(-1.0, 1.0, n)
    y = slope * x + noise * rng.randn(n)
    y[::9] += outlier
    return x, y


def make_log_joint(x, y, df=3.0, device=None, dtype=torch.float32):
    """``log p(w, sigma, y)``: ``w ~ N(0, 5)``, ``sigma ~ HalfCauchy(1)``,
    ``y_i ~ StudentT(df, w x_i, sigma)`` (the standard t shifted and
    scaled), over latents with leading chain axes."""
    kw = dict(dtype=dtype, device=device)
    xt, yt = torch.as_tensor(x, **kw), torch.as_tensor(y, **kw)
    t = zd.StudentT(torch.tensor(float(df), **kw), torch.tensor(0.0, **kw),
                    torch.tensor(1.0, **kw))
    prior_w = zd.Normal(torch.tensor(0.0, **kw), std=torch.tensor(5.0, **kw))
    prior_sigma = zd.HalfCauchy(torch.tensor(1.0, **kw))

    def log_joint(obs):
        w, sigma = obs["w"], obs["sigma"]
        lp = prior_w.log_prob(w) + prior_sigma.log_prob(sigma)
        resid = yt - w[..., None] * xt
        return lp + torch.sum(t.log_prob(resid / sigma[..., None])
                              - torch.log(sigma)[..., None], dim=-1)

    return log_joint


def make_sampler():
    return HMC(step_size=0.05, n_leapfrogs=10, adapt_step_size=True)


def main(n_chains=64, n_iters=1500, n_adapt=700, device=None, seed=0,
         verbose=True):
    """The JAX example's run: ``n_iters`` HMC iterations from ``w = 0``,
    ``sigma = 1``, the first ``n_adapt`` adapting the step size and
    dropped. Returns ``(posterior mean slope, OLS slope)``."""
    device = torch.device("cuda:0" if device is None else device)
    x, y = make_data()
    log_joint = make_log_joint(x, y, device=device)
    ulj, to_u, to_c = transform_log_joint(log_joint, {"sigma": Softplus()})
    hmc = make_sampler()
    state = hmc.init(to_u({"w": torch.zeros(n_chains, device=device),
                           "sigma": torch.ones(n_chains, device=device)}),
                     n_chain_dims=1)
    state, out = hmc.run(ulj, {}, state, (seed, 0), n_iters, n_adapt=n_adapt)
    cons = to_c({k: v[n_adapt:] for k, v in out["samples"].items()})
    w = cons["w"].reshape(-1).double().cpu().numpy()
    sigma = cons["sigma"].reshape(-1).double().cpu().numpy()
    ols = float(np.sum(x * y) / np.sum(x * x))
    if verbose:
        print("robust slope {:.3f} +- {:.3f} | sigma {:.3f} | OLS slope "
              "{:.3f} (true 2.0)".format(w.mean(), w.std(), sigma.mean(),
                                         ols))
    return float(w.mean()), ols


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-chains", type=int, default=64)
    parser.add_argument("--n-iters", type=int, default=1500)
    parser.add_argument("--n-adapt", type=int, default=700)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(args.n_chains, args.n_iters, args.n_adapt,
                resolve_device(args.device))


if __name__ == "__main__":
    _cli()
