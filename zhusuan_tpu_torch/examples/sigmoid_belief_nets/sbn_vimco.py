"""Deep sigmoid belief net trained with VIMCO.

Port of ``examples/sigmoid_belief_nets/sbn_vimco.py`` (parity: reference
``examples/sigmoid_belief_nets/sbn_vimco.py``, BASELINE config #5 part 1):
three stochastic Bernoulli layers (h_dim 200), ``importance_weighted_
objective(...).vimco()`` with k = 10, batch 24, Adam(1e-3, eps=1e-4), at
most 500 steps an epoch.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.sigmoid_belief_nets.sbn_vimco
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zhusuan_tpu_torch.evaluation import is_loglikelihood
from zhusuan_tpu_torch.examples.sigmoid_belief_nets.sbn import (
    build_q_net,
    build_sbn,
    init_sbn_params,
)
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import importance_weighted_objective

__all__ = ["vimco_loss", "make_train_step", "eval_is_loglikelihood",
           "main"]


def vimco_loss(params, x, key, h_dim, n_particles, noise=None):
    """``(mean VIMCO surrogate cost, mean importance-weighted bound)`` of a
    batch; ``noise`` holds the inference net's uniforms (see
    :func:`~zhusuan_tpu_torch.examples.sigmoid_belief_nets.sbn.
    build_q_net`)."""
    n, x_dim = x.shape
    variational = build_q_net(params, x, h_dim, n_particles, key,
                              noise=noise)
    model = build_sbn(params, n, x_dim, h_dim, n_particles)
    lower_bound = importance_weighted_objective(
        model, observed={"x": x}, variational=variational, axis=0)
    return torch.mean(lower_bound.vimco()), torch.mean(lower_bound.tensor)


def make_train_step(optimizer, h_dim, n_particles):
    """One VIMCO step: ``train_step(params, x, key, noise=None) -> bound``
    (detached, no host sync)."""

    def train_step(params, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        cost, lb = vimco_loss(params, x, key, h_dim, n_particles,
                              noise=noise)
        cost.backward()
        optimizer.step()
        return lb.detach()

    return train_step


@torch.no_grad()
def eval_is_loglikelihood(params, x, key, h_dim, n_particles=1000):
    """IS log-likelihood of ``x`` at ``n_particles`` particles, mean over
    the rows."""
    n = x.shape[0]
    variational = build_q_net(params, x, h_dim, n_particles, key)
    model = build_sbn(params, n, x.shape[1], h_dim, n_particles)
    return torch.mean(is_loglikelihood(model, {"x": x},
                                       proposal=variational, axis=0))


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

    x_train, _, x_test, synthetic = load_binary_mnist()
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    x_dim = x_train.shape[1]
    x_train_d = torch.as_tensor(x_train, device=device)
    x_test = torch.as_tensor(x_test[:500], device=device)
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
        lb = float(lbs.mean())
        print("Epoch {} ({:.1f}s): IW bound = {:.4f}".format(
            epoch, time.perf_counter() - t0, lb))
        if epoch % 5 == 0:
            (key,) = draw_keys(generator, 1)
            ll = eval_is_loglikelihood(params, x_test, key, hps.h_dim)
            print(">>> TEST LOG LIKELIHOOD (IS, k=1000) = {:.4f}".format(
                float(ll)))
    return params


if __name__ == "__main__":
    main()
