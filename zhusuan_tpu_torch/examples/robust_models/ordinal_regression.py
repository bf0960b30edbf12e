"""Ordinal (cumulative-logit) regression with Ordered cutpoints.

Port of ``examples/robust_models/ordinal_regression.py``:

.. math::
    P(y_i \\le k) = \\sigma(c_k - x_i^T \\beta), \\quad
    c_1 < c_2 < \\dots < c_{K-1},\\quad
    \\beta \\sim N(0, 1),\\; c \\sim N(0, 2^2) \\text{ (ordered)},

NUTS over ``beta`` and the ``Ordered``-unconstrained cutpoints. The
log-joint NUTS takes is the built-in
:class:`~zhusuan_tpu_torch.ops.densities.OrderedLogisticRegressionLogJoint`
(the unconstrained density ``transform_log_joint`` would build from
:func:`build_log_joint`, which gives the maps ``to_u`` / ``to_c``), so on
the card every iteration is one launch of the NUTS kernel, as the JAX
package's gate sends this run to its Pallas kernel on a TPU.

Synthetic data from known parameters (flagged ``synthetic``), drawn with
torch's generator; ``run(data=(x, y))`` takes given data instead (the JAX
example's, from ``scripts/robust_jax_reference.json``).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.robust_models.ordinal_regression
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch import distributions as zd
from zhusuan_tpu_torch.bijectors import Ordered, transform_log_joint
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import NUTS
from zhusuan_tpu_torch.ops.densities import OrderedLogisticRegressionLogJoint

__all__ = ["TRUE_BETA", "TRUE_CUTS", "make_data", "build_log_joint",
           "build_density", "make_sampler", "init_latent", "run", "main"]

TRUE_BETA = np.asarray([1.2, -0.8])
TRUE_CUTS = np.asarray([-1.0, 0.3, 1.5])  # K = 4 categories


def make_data(n, generator):
    """``(x [n, 2], y [n], synthetic)`` float64 / int64 on the CPU: ``y``
    drawn by inverting the cumulative-logit CDF."""
    x = torch.randn(n, 2, generator=generator, dtype=torch.float64)
    eta = x @ torch.as_tensor(TRUE_BETA)
    cum = torch.sigmoid(torch.as_tensor(TRUE_CUTS)[None, :] - eta[:, None])
    u = torch.rand(n, generator=generator, dtype=torch.float64)
    return x, torch.sum(u[:, None] > cum, dim=-1), True


def build_log_joint(x, y, device=None, dtype=torch.float32):
    """The model over ``beta [..., 2]`` and ``cuts [..., K - 1]`` with the
    :class:`~zhusuan_tpu_torch.distributions.OrderedLogistic` head."""
    xt = torch.as_tensor(x, dtype=dtype, device=device)
    yt = torch.as_tensor(y, device=device)

    def log_joint(obs):
        beta, cuts = obs["beta"], obs["cuts"]
        prior = (torch.sum(-0.5 * beta ** 2, dim=-1)
                 + torch.sum(-0.5 * (cuts / 2.0) ** 2, dim=-1))
        eta = beta @ xt.T
        lik = zd.OrderedLogistic(eta, cuts[..., None, :]).log_prob(yt)
        return prior + torch.sum(lik, dim=-1)

    return log_joint


def build_density(x, y):
    """The NUTS kernel's built-in for the unconstrained model, and the maps
    ``(to_u, to_c)``."""
    density = OrderedLogisticRegressionLogJoint(x, y, len(TRUE_CUTS) + 1)
    _, to_u, to_c = transform_log_joint(build_log_joint(x, y),
                                        {"cuts": Ordered()})
    return density, to_u, to_c


def make_sampler():
    return NUTS(step_size=0.2, max_tree_depth=6, adapt_step_size=True)


def init_latent(n_chains, device=None, dtype=torch.float32):
    kw = dict(dtype=dtype, device=device)
    return {"beta": torch.zeros((n_chains, 2), **kw),
            "cuts": torch.tensor([-1.0, 0.0, 1.0], **kw).repeat(n_chains, 1)}


def run(n=400, n_chains=32, n_iters=1200, burnin=400, seed=1, data=None,
        device=None):
    """NUTS from ``beta = 0``, ``cuts = (-1, 0, 1)``: ``n_iters``
    iterations, the first ``burnin`` adapting the step size and dropped.

    :param data: optional ``(x [n, 2], y [n])``; else synthetic data from
        ``seed``.
    """
    device = torch.device("cuda:0" if device is None else device)
    if data is None:
        x, y, synthetic = make_data(n, torch.Generator().manual_seed(seed))
    else:
        (x, y), synthetic = data, True
    density, to_u, to_c = build_density(x, y)
    nuts = make_sampler()
    state = nuts.init(to_u(init_latent(n_chains, device)), n_chain_dims=1)
    state, out = nuts.run(density, {}, state, (seed, 2), n_iters,
                          n_adapt=burnin)
    draws = to_c({k: v[burnin:] for k, v in out["samples"].items()})
    beta = draws["beta"].reshape(-1, 2).double().cpu().numpy()
    cuts = draws["cuts"].reshape(-1, 3).double().cpu().numpy()
    return {
        "synthetic": synthetic,
        "beta_mean": beta.mean(0),
        "beta_sd": beta.std(0),
        "cuts_mean": cuts.mean(0),
        "cuts_sd": cuts.std(0),
        "cuts_draws": cuts,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=400)
    parser.add_argument("--n-chains", type=int, default=32)
    parser.add_argument("--n-iters", type=int, default=1200)
    parser.add_argument("--burnin", type=int, default=400)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    res = run(args.n, args.n_chains, args.n_iters, args.burnin,
              device=resolve_device(args.device))
    print("ordinal regression: beta={} (true {}), cuts={} (true {})".format(
        np.round(res["beta_mean"], 2), TRUE_BETA,
        np.round(res["cuts_mean"], 2), TRUE_CUTS))
    return res


if __name__ == "__main__":
    main()
