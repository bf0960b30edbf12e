"""Data-parallel training over a device mesh (port of
``examples/utils/multi_device.py``).

Parity target: reference ``examples/utils/multi_gpu.py`` (in-graph tower
replication with CPU-side ``average_gradients``, :24-60). Here each process
drives one device: :func:`zhusuan_tpu_torch.parallel.data_parallel_grad`
computes the loss and gradients on the rank's shard of the batch and
averages them with one all-reduce; the parameters stay the same on every
rank, as every rank applies the same Adam step. This module demonstrates it
on the VAE.

Run under ``torchrun`` (one process a card; the process group comes from
its environment), or alone: a world of 1 on the card, NCCL over a
``FileStore`` in a temporary directory (no TCP), or gloo with
``--device cpu``::

    python -m zhusuan_tpu_torch.examples.utils.multi_device [--steps N]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from zhusuan_tpu_torch.ops._random import child_key
from zhusuan_tpu_torch.parallel import chain_mesh, data_parallel_grad


def init_world_of_one(device):
    """Initialise a process group of one rank without TCP: NCCL for a CUDA
    ``device``, gloo for the CPU, over a ``FileStore``. Returns the store's
    directory (remove it after ``destroy_process_group``)."""
    store_dir = tempfile.mkdtemp(prefix="zs_world_of_one_")
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=0, world_size=1)
    return store_dir


def vae_loss_fn(z_dim):
    """The data-parallel loss: the VAE's negative ELBO on a batch shard,
    its variational net keyed by the shard's key pair."""
    from zhusuan_tpu_torch.examples.variational_autoencoders.vae import (
        elbo_loss,
    )

    def loss_fn(params, batch, key):
        return elbo_loss(params, batch, (key[0] << 32) | key[1], z_dim)

    return loss_fn


def main(steps=100, z_dim=40, per_device_batch=64, device=None,
         log_every=20):
    """Train the VAE for ``steps`` data-parallel Adam steps on the binary
    MNIST training set, batch ``per_device_batch`` a rank.

    :param device: this rank's device (default: the current card). Without
        an initialised process group, a world of 1 is made on it and torn
        down at the end (:func:`init_world_of_one`).
    :return: the trained parameters.
    """
    from zhusuan_tpu_torch.examples.utils.dataset import load_binary_mnist
    from zhusuan_tpu_torch.examples.variational_autoencoders.vae import (
        init_params,
    )

    device = (torch.device("cuda", torch.cuda.current_device())
              if device is None else torch.device(device))
    store_dir = None if dist.is_initialized() else init_world_of_one(device)
    try:
        n_dev = dist.get_world_size()
        mesh = chain_mesh(axis_name="dp", device_type=device.type)
        print("Devices: {} -> mesh {}".format(n_dev, mesh))

        x_train, _, _, _ = load_binary_mnist()
        batch_size = per_device_batch * n_dev
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             784, z_dim)
        leaves = pytree.tree_leaves(params)
        optimizer = torch.optim.Adam(leaves, lr=1e-3)
        dp_value_and_grad = data_parallel_grad(vae_loss_fn(z_dim), mesh,
                                               axis_name="dp")

        t0 = time.time()
        for i in range(steps):
            idx = np.random.RandomState(i).randint(0, x_train.shape[0],
                                                   batch_size)
            loss, grads = dp_value_and_grad(
                params, torch.as_tensor(x_train[idx], device=device),
                child_key((0, 0), i))
            for p, g in zip(leaves, pytree.tree_leaves(grads)):
                p.grad = g
            optimizer.step()
            if i % log_every == 0:
                print("step {}: -elbo = {:.2f}".format(i, float(loss)))
        print("{} steps on {} devices in {:.1f}s".format(
            steps, n_dev, time.time() - t0))
        return params
    finally:
        if store_dir is not None:
            dist.destroy_process_group()
            shutil.rmtree(store_dir, ignore_errors=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    if "WORLD_SIZE" in os.environ:  # under torchrun
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = (torch.device("cuda", local) if args.device is None
               else torch.device(args.device))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        try:
            main(steps=args.steps, device=dev)
        finally:
            dist.destroy_process_group()
    else:
        main(steps=args.steps, device=args.device)
