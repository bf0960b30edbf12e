"""VAE with a planar-normalizing-flow-enriched posterior.

Port of ``examples/normalizing_flows/vae_nf.py`` (parity: reference
``examples/normalizing_flows/vae_nf.py``): the VAE of
:mod:`~zhusuan_tpu_torch.examples.variational_autoencoders.vae`
(784-500-500 encoder, z 40, 40-500-500-784 decoder) with ten planar flows
applied to the q samples, plugged into the ELBO through
``latent={name: (samples, log_probs)}`` (reference :70-77); Adam 1e-3,
batch 128, 10 epochs of binarized MNIST (the synthetic set where the files
are absent).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.normalizing_flows.vae_nf
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.dataset import load_binary_mnist
from zhusuan_tpu_torch.examples.variational_autoencoders.vae import (
    build_gen,
    build_q,
)
from zhusuan_tpu_torch.examples.variational_autoencoders.vae import (
    init_params as init_vae_params,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.transform import (
    init_planar_flow,
    planar_normalizing_flow,
)
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import elbo

__all__ = ["nf_elbo_loss", "init_params", "make_train_step", "run_epoch",
           "main"]


def nf_elbo_loss(params, x, key, z_dim, n_particles=1, n_flows=10,
                 noise=None):
    """Negative ELBO of the flow-enriched posterior, mean over the batch;
    ``noise={"z": eps}`` gives q's base normals (testing hook)."""
    n = x.shape[0]
    variational = build_q(params, x, z_dim, n_particles, key, noise=noise)
    z_node = variational["z"]
    # Enrich q with planar flows (reference vae_nf.py:70-77).
    z_flowed, log_qz_flowed = planar_normalizing_flow(
        z_node.tensor, z_node.cond_log_p, params["flow"])
    model = build_gen(params, x.shape[-1], z_dim, n, n_particles)
    lower_bound = elbo(model, {"x": x},
                       latent={"z": (z_flowed, log_qz_flowed)}, axis=0)
    return torch.mean(lower_bound.sgvb())


def init_params(generator, x_dim=784, z_dim=40, n_flows=10, hidden=500,
                dtype=torch.float32):
    """The VAE's parameters and ``n_flows`` planar flows on ``z``, drawn
    from ``generator`` (on the device they go to), as leaves that require
    grad."""
    params = init_vae_params(generator, x_dim, z_dim, hidden, dtype)
    params["flow"] = [{k: v.requires_grad_(True) for k, v in p.items()}
                      for p in init_planar_flow(generator, n_flows, z_dim,
                                                dtype)]
    return params


def make_train_step(optimizer, z_dim):
    """One step: ``train_step(params, x, key, noise=None) -> lower bound``
    (detached, no host sync)."""

    def train_step(params, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = nf_elbo_loss(params, x, key, z_dim, noise=noise)
        loss.backward()
        optimizer.step()
        return -loss.detach()

    return train_step


def run_epoch(step_fn, params, x_train, epoch, generator, batch_size=128,
              max_steps=None):
    """One epoch over ``x_train`` (a device tensor) in the order of
    ``RandomState(epoch).permutation``; the step keys from the CPU
    ``generator``. Returns the per-step bounds (a device vector)."""
    n_batches = x_train.shape[0] // batch_size
    if max_steps is not None:
        n_batches = min(n_batches, int(max_steps))
    perm = torch.as_tensor(
        np.random.RandomState(epoch).permutation(x_train.shape[0]),
        device=x_train.device)
    lbs = torch.empty((n_batches,), dtype=x_train.dtype,
                      device=x_train.device)
    for i, key in enumerate(draw_keys(generator, n_batches)):
        lbs[i] = step_fn(
            params, x_train[perm[i * batch_size:(i + 1) * batch_size]], key)
    return lbs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    x_train, _, _, synthetic = load_binary_mnist()
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    x_dim, z_dim, n_flows = 784, 40, 10
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         x_dim, z_dim, n_flows)
    step_fn = make_train_step(
        torch.optim.Adam(tree_leaves(params), lr=1e-3), z_dim)
    x_train = torch.as_tensor(x_train, device=device)
    generator = torch.Generator().manual_seed(1234)
    for epoch in range(1, hps.epochs + 1):
        t0 = time.time()
        lbs = run_epoch(step_fn, params, x_train, epoch, generator)
        print("Epoch {} ({:.1f}s): Lower bound = {:.4f}".format(
            epoch, time.time() - t0, float(lbs.mean())))
    return params


if __name__ == "__main__":
    main()
