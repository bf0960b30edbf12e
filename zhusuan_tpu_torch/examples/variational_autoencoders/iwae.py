"""Importance-weighted autoencoder (IWAE) on binarized MNIST.

Port of ``examples/variational_autoencoders/iwae.py`` (parity: reference
``examples/variational_autoencoders/iwae.py``, BASELINE config #3 part 2):
the VAE's 2x500 nets trained on ``importance_weighted_objective(...)
.sgvb()`` with k = 50, batch 64, Adam 1e-3.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.variational_autoencoders.iwae
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.variational_autoencoders.vae import (
    build_gen,
    build_q,
    eval_is_loglikelihood,
    init_params,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import importance_weighted_objective

__all__ = ["iwae_loss", "make_train_step", "main"]


def iwae_loss(params, x, key, z_dim, n_particles=50, noise=None):
    """The negative importance-weighted bound, mean over the batch (the
    IWAE surrogate); ``noise={"z": eps}`` replaces the draws."""
    n = x.shape[0]
    variational = build_q(params, x, z_dim, n_particles, key, noise=noise)
    model = build_gen(params, x.shape[-1], z_dim, n, n_particles)
    lower_bound = importance_weighted_objective(
        model, {"x": x}, variational=variational, axis=0)
    return torch.mean(lower_bound.sgvb())


def make_train_step(optimizer, z_dim, n_particles=50):
    """One IWAE step: ``train_step(params, x, key, noise=None) -> bound``
    (detached, no host sync)."""

    def train_step(params, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = iwae_loss(params, x, key, z_dim, n_particles, noise=noise)
        loss.backward()
        optimizer.step()
        return -loss.detach()

    return train_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--n_test", default=1000, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    from zhusuan_tpu_torch.examples.utils.dataset import load_binary_mnist

    x_train, _, x_test, synthetic = load_binary_mnist()
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    x_dim, z_dim, k = 784, 40, 50
    x_train_d = torch.as_tensor(x_train, device=device)
    x_test = torch.as_tensor(x_test[:hps.n_test], device=device)
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         x_dim, z_dim)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3)
    train_step = make_train_step(optimizer, z_dim, k)
    generator = torch.Generator().manual_seed(1234)

    n_batches = x_train.shape[0] // hps.batch_size
    for epoch in range(1, hps.epochs + 1):
        t0 = time.perf_counter()
        perm = torch.as_tensor(
            np.random.RandomState(epoch).permutation(x_train.shape[0]),
            device=device)
        lbs = torch.empty(n_batches, device=device)
        for i, key in enumerate(draw_keys(generator, n_batches)):
            idx = perm[i * hps.batch_size:(i + 1) * hps.batch_size]
            lbs[i] = train_step(params, x_train_d[idx], key)
        lb = float(lbs.mean())
        print("Epoch {} ({:.1f}s): IW bound (k={}) = {:.4f}".format(
            epoch, time.perf_counter() - t0, k, lb))
        if epoch % 5 == 0:
            test_ll = eval_is_loglikelihood(params, x_test, generator, z_dim,
                                            1000)
            print(">>> TEST LOG LIKELIHOOD (IS, k=1000) = {:.4f}".format(
                test_ll))
    return params


if __name__ == "__main__":
    main()
