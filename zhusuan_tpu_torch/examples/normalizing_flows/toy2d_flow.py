"""Coupling-flow VI on the 2-D intractable (funnel-like) posterior.

Port of ``examples/normalizing_flows/toy2d_flow.py``: the target of
``toy_examples/toy2d_intractable`` (``z2 ~ N(0, 1.35)``, ``z1 ~ N(0,
e^{z2})``) over a packed ``z = [z1, z2]``, with a
:class:`~zhusuan_tpu_torch.distributions.FlowDistribution` of RealNVP
affine couplings as the variational family: one coupling expresses the
funnel's dependence of ``z1``'s scale on ``z2``, which a mean-field family
cannot. The flow's ELBO, a lower bound on ``log Z = 0``, should end near 0.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.normalizing_flows.toy2d_flow
"""

from __future__ import annotations

import argparse
import math

import torch

from zhusuan_tpu_torch import variational
from zhusuan_tpu_torch.distributions import FlowDistribution, Normal
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet
from zhusuan_tpu_torch.transform import init_affine_coupling

__all__ = ["log_joint", "build_flow_variational", "loss_fn",
           "make_train_step", "run", "main"]


def log_joint(obs):
    """The funnel's joint density over a packed ``z = [z1, z2]`` node."""
    z1, z2 = obs["z"][..., 0], obs["z"][..., 1]
    log_pz2 = -0.5 * (z2 / 1.35) ** 2 - math.log(
        1.35 * math.sqrt(2.0 * math.pi))
    log_pz1 = (-0.5 * (z1 / torch.exp(z2)) ** 2 - z2
               - 0.5 * math.log(2.0 * math.pi))
    return log_pz2 + log_pz1


def build_flow_variational(params, n_particles, key, noise=None):
    """The flow family over ``z``: couplings on a standard normal base in
    the parameters' dtype and on their device; ``noise={"z": eps}`` gives
    the base normals ``[n_particles, 2]`` (testing hook)."""
    w = params[0]["w1"]
    base = Normal(torch.zeros(2, dtype=w.dtype, device=w.device),
                  std=torch.ones(2, dtype=w.dtype, device=w.device),
                  group_ndims=1)
    bn = BayesianNet(key=key, noise=noise)
    bn.stochastic("z", FlowDistribution.coupling(base, params),
                  n_samples=n_particles)
    return bn


def loss_fn(params, n_particles, key, noise=None):
    """The SGVB cost (the negative ELBO over the particles)."""
    variational_net = build_flow_variational(params, n_particles, key,
                                             noise=noise)
    return variational.elbo(log_joint, {}, variational=variational_net,
                            axis=0).sgvb()


def make_train_step(optimizer, n_particles):
    """One Adam step: ``train_step(params, key, noise=None) -> lower
    bound`` (detached, no host sync)."""

    def train_step(params, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, n_particles, key, noise=noise)
        loss.backward()
        optimizer.step()
        return -loss.detach()

    return train_step


def run(device, n_iters=800, n_particles=500, n_flows=6, hidden=32,
        dtype=torch.float32, seed=0, verbose=True):
    """Fit the flow; ``(final flow ELBO averaged over 20 fresh keys,
    params, per-step bounds [n_iters] on the device)``."""
    device = torch.device(device)
    params = init_affine_coupling(
        torch.Generator(device=device).manual_seed(seed), n_flows, 2,
        hidden=hidden, dtype=dtype)
    leaves = [v.requires_grad_(True) for p in params for v in p.values()]
    step = make_train_step(torch.optim.Adam(leaves, lr=5e-3), n_particles)
    keys = draw_keys(torch.Generator().manual_seed(seed + 1), n_iters + 20)
    bounds = torch.empty((n_iters,), dtype=dtype, device=device)
    for i in range(n_iters):
        bounds[i] = step(params, keys[i])
        if verbose and i % 100 == 0:
            print("Iteration {}: flow lower bound = {:.4f}".format(
                i, float(bounds[i])))
    # The bound averaged over fresh keys: a low-noise final estimate.
    with torch.no_grad():
        lbs = torch.stack([-loss_fn(params, n_particles, k)
                           for k in keys[n_iters:]])
    flow_lb = float(lbs.mean())
    if verbose:
        print("Final flow ELBO: {:.4f} (true log Z = 0)".format(flow_lb))
    return flow_lb, params, bounds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_iters", default=800, type=int)
    parser.add_argument("--n_particles", default=500, type=int)
    parser.add_argument("--n_flows", default=6, type=int)
    parser.add_argument("--hidden", default=32, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    flow_lb, params, _ = run(resolve_device(hps.device), hps.n_iters,
                             hps.n_particles, hps.n_flows, hps.hidden)
    return flow_lb, params


if __name__ == "__main__":
    main()
