"""Bayesian Gaussian mixture model with marginalized assignments.

Port of ``examples/mixture_models/gmm.py``: unknown weights, locations and
scales under the :class:`~zhusuan_tpu_torch.distributions.Mixture` head,
which marginalizes the discrete assignment out of ``log_prob``, so HMC
samples the posterior directly. All parameters are unconstrained (softmax
weights, log scales). The latents are three tensors, so HMC takes its
plain transition, as the JAX package's HMC gate (one latent) sends it to
its scan path.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.mixture_models.gmm
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch import distributions as zd
from zhusuan_tpu_torch.diagnostics import summary
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import HMC

__all__ = ["TRUE_W", "TRUE_MU", "TRUE_SD", "make_data", "make_log_joint",
           "make_sampler", "init_latent", "responsibilities", "main"]

TRUE_W = np.asarray([0.25, 0.45, 0.30])
TRUE_MU = np.asarray([-4.0, 0.0, 5.0])
TRUE_SD = np.asarray([0.7, 1.0, 1.2])


def make_data(n=600, seed=0):
    """``(x [n], component [n])`` numpy: the JAX example's
    ``default_rng`` draws."""
    rng = np.random.default_rng(seed)
    comp = rng.choice(3, size=n, p=TRUE_W)
    return (TRUE_MU[comp] + TRUE_SD[comp] * rng.normal(size=n)), comp


def make_log_joint(data, k=3, device=None, dtype=torch.float32):
    """``log p(logits, mu, log_sd, data)``: ``N(0, 2)`` logits, ``N(0, 10)``
    locations, ``N(0, 1)`` log scales (without constants) and the Mixture
    likelihood, over latents ``[..., k]`` with leading chain axes."""
    x = torch.as_tensor(data, dtype=dtype, device=device)

    def log_joint(obs):
        logits, mu, log_sd = obs["logits"], obs["mu"], obs["log_sd"]
        lp = torch.sum(-0.5 * (logits / 2.0) ** 2, dim=-1)
        lp = lp + torch.sum(-0.5 * (mu / 10.0) ** 2, dim=-1)
        lp = lp + torch.sum(-0.5 * log_sd ** 2, dim=-1)
        mix = zd.Mixture(logits, zd.Normal(mu, logstd=log_sd))
        # x [n] -> [n, 1, ..., 1]: log_prob is [n] + chain axes.
        xb = x.reshape((x.shape[0],) + (1,) * (mu.ndim - 1))
        return lp + torch.sum(mix.log_prob(xb), dim=0)

    return log_joint


def responsibilities(x, logits, mu, log_sd):
    """Posterior assignment probabilities ``r [n, k]`` at one parameter
    set."""
    lw = torch.log_softmax(logits, -1)
    comp_lp = zd.Normal(mu, logstd=log_sd).log_prob(x[:, None])
    return torch.softmax(lw + comp_lp, dim=-1)


def make_sampler():
    return HMC(step_size=0.05, n_leapfrogs=20, adapt_step_size=True)


def init_latent(n_chains, device=None, dtype=torch.float32):
    """The JAX example's initial state: zero logits and log scales,
    locations from ``default_rng(1).normal(0, 3)``."""
    kw = dict(dtype=dtype, device=device)
    return {
        "logits": torch.zeros((n_chains, 3), **kw),
        "mu": torch.as_tensor(
            np.random.default_rng(1).normal(0, 3, size=(n_chains, 3)), **kw),
        "log_sd": torch.zeros((n_chains, 3), **kw),
    }


def main(n_chains=16, n_iters=1500, n_adapt=800, n_data=600, verbose=True,
         seed=42, device=None):
    """The windowed warmup (``n_adapt`` iterations), then ``n_iters``
    sampling iterations; components ordered by location in every draw.
    Returns ``((w, mu, sd) posterior means, clustering accuracy against the
    true labels, summary stats of the ordered locations)``."""
    device = torch.device("cuda:0" if device is None else device)
    x, true_comp = make_data(n_data)
    log_joint = make_log_joint(x, device=device)
    hmc = make_sampler()
    state = hmc.init(init_latent(n_chains, device), n_chain_dims=1)
    state = hmc.warmup_run(log_joint, {}, state, (seed, 1), n_warmup=n_adapt)
    state, info = hmc.run(log_joint, {}, state, (seed, 2), n_iters=n_iters)

    samples = {k: v.double() for k, v in info["samples"].items()}
    # Undo label switching per draw: order components by their mean.
    order = torch.argsort(samples["mu"], dim=-1)
    mu_s = torch.take_along_dim(samples["mu"], order, -1)
    sd_s = torch.exp(torch.take_along_dim(samples["log_sd"], order, -1))
    w_s = torch.take_along_dim(torch.softmax(samples["logits"], -1), order,
                               -1)
    stats, _ = summary({"mu": mu_s})
    post_mu = mu_s.reshape(-1, 3).mean(0)
    post_sd = sd_s.reshape(-1, 3).mean(0)
    post_w = w_s.reshape(-1, 3).mean(0)
    r = responsibilities(torch.as_tensor(x, device=post_mu.device),
                         torch.log(post_w), post_mu, torch.log(post_sd))
    acc = float(np.mean(torch.argmax(r, -1).cpu().numpy() == true_comp))
    post_w, post_mu, post_sd = (v.cpu().numpy()
                                for v in (post_w, post_mu, post_sd))
    if verbose:
        print("posterior weights:", np.round(post_w, 3), "(true", TRUE_W,
              ")")
        print("posterior means:  ", np.round(post_mu, 3), "(true", TRUE_MU,
              ")")
        print("posterior sds:    ", np.round(post_sd, 3), "(true", TRUE_SD,
              ")")
        print("clustering accuracy vs true labels:", acc)
        print("acceptance:", float(info["acceptance_rate"].mean()))
    return (post_w, post_mu, post_sd), acc, stats


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-chains", type=int, default=16)
    parser.add_argument("--n-iters", type=int, default=1500)
    parser.add_argument("--n-adapt", type=int, default=800)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(args.n_chains, args.n_iters, args.n_adapt,
                device=resolve_device(args.device))


if __name__ == "__main__":
    _cli()
