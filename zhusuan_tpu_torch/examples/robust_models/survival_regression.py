"""Weibull AFT survival regression with right-censored observations.

Port of ``examples/robust_models/survival_regression.py``:

.. math::
    T_i \\sim \\mathrm{Weibull}(k, \\lambda_i),\\quad
    \\log \\lambda_i = x_i^T \\beta,\\quad
    y_i = \\min(T_i, c_i),

the observed ``y_i`` scoring the event density when ``y_i < c_i`` and the
survival mass when censored
(:class:`~zhusuan_tpu_torch.distributions.RightCensored`). NUTS samples
``(k, beta)``, ``k`` on its Softplus-unconstrained scale. The log-joint
NUTS takes is the built-in
:class:`~zhusuan_tpu_torch.ops.densities.WeibullAFTLogJoint`, which holds
``y`` (the run passes it as ``observed``, as the JAX example does), so on
the card every iteration is one launch of the NUTS kernel, as the JAX
package's gate sends this run to its Pallas kernel on a TPU;
:func:`build_log_joint` gives the maps ``to_u`` / ``to_c``.

Synthetic data from known parameters (flagged ``synthetic``; about 40%
censored) drawn with torch's generator; ``run(data=(x, y, c))`` takes given
data instead (the JAX example's, from ``scripts/robust_jax_reference.json``).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.robust_models.survival_regression
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.bijectors import Softplus, transform_log_joint
from zhusuan_tpu_torch.distributions import RightCensored, Weibull
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import NUTS
from zhusuan_tpu_torch.ops.densities import WeibullAFTLogJoint

__all__ = ["TRUE_K", "TRUE_BETA", "make_data", "build_log_joint",
           "build_density", "make_sampler", "init_latent", "run", "main"]

TRUE_K = 1.5
TRUE_BETA = np.asarray([0.7, 0.8, -0.5])  # intercept + 2 covariates


def make_data(n, generator):
    """``(x [n, 3], y [n], c [n], censored fraction, synthetic)`` float64
    on the CPU: Weibull event times, exponential censor times of mean 3."""
    x = torch.cat([torch.ones(n, 1, dtype=torch.float64),
                   torch.randn(n, 2, generator=generator,
                               dtype=torch.float64)], dim=-1)
    lam = torch.exp(x @ torch.as_tensor(TRUE_BETA))
    t = Weibull(torch.full((n,), TRUE_K, dtype=torch.float64), lam).sample(
        generator)
    c = -3.0 * torch.log(torch.rand(n, generator=generator,
                                    dtype=torch.float64))
    y = torch.minimum(t, c)
    return x, y, c, float(torch.mean((t > c).double())), True


def build_log_joint(x, y, c, device=None, dtype=torch.float32):
    """The model over ``k [...]`` and ``beta [..., 3]``, scoring
    ``obs["y"]`` under :class:`~zhusuan_tpu_torch.distributions.
    RightCensored`."""
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    ct = torch.as_tensor(c, dtype=dtype, device=device)

    def log_joint(obs):
        k, beta = obs["k"], obs["beta"]
        prior = (-0.5 * ((k - 1.0) / 1.0) ** 2
                 + torch.sum(-0.5 * beta ** 2, dim=-1))
        lam = torch.exp(beta @ xt.T)
        dist = RightCensored(Weibull(k[..., None] * torch.ones_like(lam),
                                     lam), ct)
        return prior + torch.sum(dist.log_prob(obs["y"]), dim=-1)

    return log_joint


def build_density(x, y, c):
    """The NUTS kernel's built-in (holding ``y``, the tensor it is given),
    and the maps ``(to_u, to_c)``."""
    density = WeibullAFTLogJoint(x, y, c)
    _, to_u, to_c = transform_log_joint(build_log_joint(x, y, c),
                                        {"k": Softplus()})
    return density, to_u, to_c


def make_sampler():
    return NUTS(step_size=0.1, max_tree_depth=6, adapt_step_size=True)


def init_latent(n_chains, device=None, dtype=torch.float32):
    kw = dict(dtype=dtype, device=device)
    return {"k": torch.ones(n_chains, **kw),
            "beta": torch.zeros((n_chains, 3), **kw)}


def run(n=500, n_chains=16, n_iters=1200, burnin=400, seed=4, data=None,
        device=None):
    """NUTS from ``k = 1``, ``beta = 0``: ``n_iters`` iterations, the first
    ``burnin`` adapting the step size and dropped.

    :param data: optional ``(x [n, 3], y [n], c [n])``; else synthetic data
        from ``seed``.
    """
    device = torch.device("cuda:0" if device is None else device)
    if data is None:
        x, y, c, frac, synthetic = make_data(
            n, torch.Generator().manual_seed(seed))
    else:
        x, y, c = (torch.as_tensor(v, dtype=torch.float64) for v in data)
        frac, synthetic = float(torch.mean((y >= c).double())), True
    density, to_u, to_c = build_density(x, y, c)
    nuts = make_sampler()
    state = nuts.init(to_u(init_latent(n_chains, device)), n_chain_dims=1)
    state, out = nuts.run(density, {"y": y}, state, (seed, 9), n_iters,
                          n_adapt=burnin)
    draws = to_c({k: v[burnin:] for k, v in out["samples"].items()})
    k_draws = draws["k"].reshape(-1).double().cpu().numpy()
    beta = draws["beta"].reshape(-1, 3).double().cpu().numpy()
    return {
        "synthetic": synthetic,
        "frac_censored": frac,
        "k_mean": float(k_draws.mean()),
        "k_sd": float(k_draws.std()),
        "beta_mean": beta.mean(0),
        "beta_sd": beta.std(0),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=500)
    parser.add_argument("--n-chains", type=int, default=16)
    parser.add_argument("--n-iters", type=int, default=1200)
    parser.add_argument("--burnin", type=int, default=400)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    res = run(args.n, args.n_chains, args.n_iters, args.burnin,
              device=resolve_device(args.device))
    print("survival regression ({:.0%} censored): k={:.2f}+-{:.2f} (true "
          "{}), beta={} (true {})".format(
              res["frac_censored"], res["k_mean"], res["k_sd"], TRUE_K,
              np.round(res["beta_mean"], 2), TRUE_BETA))
    return res


if __name__ == "__main__":
    main()
