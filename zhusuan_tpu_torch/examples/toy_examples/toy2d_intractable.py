"""Mean-field SGVB on a 2-D intractable (funnel-like) posterior.

Port of ``examples/toy_examples/toy2d_intractable.py`` (parity: reference
``examples/toy_examples/toy2d_intractable.py``, BASELINE config #2): model
``z2 ~ N(0, 1.35)``, ``z1 ~ N(0, e^{z2})``; a mean-field Normal
``BayesianNet`` guide with learnable means and log-stds initialized at
(-2, -5); ``elbo(...).sgvb()`` with Adam(0.1) and 500 particles (the
measured recipe, ``baseline_ref/configs_protocol.py:29``).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.toy_examples.toy2d_intractable
"""

from __future__ import annotations

import argparse

import torch

from zhusuan_tpu_torch import variational
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net

__all__ = ["PARAM_NAMES", "build_toy2d_intractable",
           "build_mean_field_variational", "init_params", "loss_fn",
           "make_train_step", "main"]

PARAM_NAMES = ("z1_mean", "z1_logstd", "z2_mean", "z2_logstd")


@meta_bayesian_net()
def build_toy2d_intractable(n_particles, dtype=torch.float32, device=None):
    """The model p(z2) p(z1 | z2). The JAX example's scalar parameters are
    float32 weak types; ``dtype`` and ``device`` place them here."""
    bn = BayesianNet()
    zero = torch.zeros((), dtype=dtype, device=device)
    z2 = bn.normal("z2", zero, std=1.35, n_samples=n_particles)
    bn.normal("z1", zero, logstd=z2.tensor)
    return bn


def build_mean_field_variational(params, n_particles, key, noise=None):
    """The mean-field Normal guide over ``z1`` and ``z2``; ``noise={"z1":
    eps, "z2": eps}`` replaces its draws (testing hook)."""
    bn = BayesianNet(key=key, noise=noise)
    for name in ["z1", "z2"]:
        bn.normal(name, params[name + "_mean"],
                  logstd=params[name + "_logstd"], n_samples=n_particles)
    return bn


def init_params(dtype=torch.float32, device=None):
    """The guide's starting point: means -2, log-stds -5 (leaf tensors that
    require grad; the card when ``device`` is None)."""
    device = torch.device("cuda", 0) if device is None else device
    start = {"z1_mean": -2.0, "z1_logstd": -5.0, "z2_mean": -2.0,
             "z2_logstd": -5.0}
    return {k: torch.tensor(v, dtype=dtype, device=device,
                            requires_grad=True) for k, v in start.items()}


def loss_fn(model, params, n_particles, key, noise=None):
    """``(sgvb cost, lower bound)``, both averaged over the particles."""
    guide = build_mean_field_variational(params, n_particles, key,
                                         noise=noise)
    lower_bound = variational.elbo(model, {}, variational=guide, axis=0)
    return lower_bound.sgvb(), lower_bound.tensor


def make_train_step(model, optimizer, n_particles):
    """One Adam step: ``train_step(params, key, noise=None) -> lower
    bound`` (detached, no host sync)."""

    def train_step(params, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        cost, lb = loss_fn(model, params, n_particles, key, noise=noise)
        cost.backward()
        optimizer.step()
        return lb.detach()

    return train_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_iters", default=600, type=int)
    parser.add_argument("--n_particles", default=500, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    model = build_toy2d_intractable(hps.n_particles, device=device)
    params = init_params(device=device)
    optimizer = torch.optim.Adam([params[k] for k in PARAM_NAMES], lr=0.1)
    train_step = make_train_step(model, optimizer, hps.n_particles)
    keys = draw_keys(torch.Generator().manual_seed(0), hps.n_iters)
    for i, key in enumerate(keys):
        lb = train_step(params, key)
        if i % 100 == 0:
            print("Iteration {}: lower bound = {:.4f}".format(i, float(lb)))
    print("Final variational params:",
          {k: v.item() for k, v in params.items()})
    return params


if __name__ == "__main__":
    main()
