"""Deep sigmoid belief net with adaptive importance sampling (RWS-style).

Port of ``examples/sigmoid_belief_nets/sbn_adaptive_is.py`` (parity:
reference ``examples/sigmoid_belief_nets/sbn_adaptive_is.py``): the model
(784-200-200-200) is trained on the importance-weighted bound while the
proposal is adapted with the self-normalized IS gradient of KL(p || q)
(``klpq(...).importance()``, reference :75-87); both parameter groups move
in one Adam(1e-3, eps=1e-4) step, k = 10, batch 24, at most 500 steps an
epoch.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.sigmoid_belief_nets.sbn_adaptive_is
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zhusuan_tpu_torch.examples.sigmoid_belief_nets.sbn import (
    build_q_net,
    build_sbn,
    init_sbn_params,
)
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.utils import tree_leaves, tree_map
from zhusuan_tpu_torch.variational import importance_weighted_objective, klpq

__all__ = ["MODEL_KEYS", "PROPOSAL_KEYS", "combined_cost",
           "make_train_step", "main"]

MODEL_KEYS = ("g_h3_h2", "g_h2_h1", "g_h1_x")
PROPOSAL_KEYS = ("q_x_h1", "q_h1_h2", "q_h2_h3")


def _keep(params, keys):
    """``params`` with every group outside ``keys`` detached."""
    return {k: (v if k in keys else tree_map(torch.Tensor.detach, v))
            for k, v in params.items()}


def combined_cost(params, x, key, h_dim, n_particles, noise=None):
    """``(model cost + proposal cost, mean IW bound)``: the model's
    gradient comes from ``-IW bound`` with the proposal detached, the
    proposal's from ``klpq(...).importance()`` with the model detached
    (reference :75-87). Both costs see the same proposal draws (one
    ``key``; ``noise`` replaces the inference net's uniforms)."""
    n, x_dim = x.shape
    params_model = _keep(params, MODEL_KEYS)
    variational = build_q_net(params_model, x, h_dim, n_particles, key,
                              noise=noise)
    model = build_sbn(params_model, n, x_dim, h_dim, n_particles)
    lower_bound = importance_weighted_objective(
        model, observed={"x": x}, variational=variational, axis=0)
    model_cost = -torch.mean(lower_bound.tensor)

    params_prop = _keep(params, PROPOSAL_KEYS)
    variational2 = build_q_net(params_prop, x, h_dim, n_particles, key,
                               noise=noise)
    model2 = build_sbn(params_prop, n, x_dim, h_dim, n_particles)
    klpq_cost = torch.mean(klpq(model2, observed={"x": x},
                                variational=variational2,
                                axis=0).importance())
    return model_cost + klpq_cost, torch.mean(lower_bound.tensor)


def make_train_step(optimizer, h_dim, n_particles):
    """One step: ``train_step(params, x, key, noise=None) -> IW bound``
    (detached, no host sync)."""

    def train_step(params, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        cost, lb = combined_cost(params, x, key, h_dim, n_particles,
                                 noise=noise)
        cost.backward()
        optimizer.step()
        return lb.detach()

    return train_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=24, type=int)
    parser.add_argument("--lb_samples", default=10, type=int)
    parser.add_argument("--h_dim", default=200, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    from zhusuan_tpu_torch.examples.utils.dataset import load_binary_mnist

    x_train, _, _, synthetic = load_binary_mnist()
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    x_dim = x_train.shape[1]
    x_train_d = torch.as_tensor(x_train, device=device)
    params = init_sbn_params(
        torch.Generator(device=device).manual_seed(1234), x_dim, hps.h_dim)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3, eps=1e-4)
    train_step = make_train_step(optimizer, hps.h_dim, hps.lb_samples)
    generator = torch.Generator().manual_seed(1234)

    iters = min(x_train.shape[0] // hps.batch_size, 500)
    for epoch in range(1, hps.epochs + 1):
        t0 = time.perf_counter()
        perm = torch.as_tensor(
            np.random.RandomState(epoch).permutation(x_train.shape[0]),
            device=device)
        lbs = torch.empty(iters, device=device)
        for t, key in enumerate(draw_keys(generator, iters)):
            idx = perm[t * hps.batch_size:(t + 1) * hps.batch_size]
            lbs[t] = train_step(params, x_train_d[idx], key)
        print("Epoch {} ({:.1f}s): IW bound = {:.4f}".format(
            epoch, time.perf_counter() - t0, float(lbs.mean())))
    return params


if __name__ == "__main__":
    main()
