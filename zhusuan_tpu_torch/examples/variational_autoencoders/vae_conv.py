"""Convolutional VAE on binarized MNIST.

Port of ``examples/variational_autoencoders/vae_conv.py`` (parity:
reference ``examples/variational_autoencoders/vae_conv.py``): a conv
encoder 28x28x1 -> 14x14x32 -> 7x7x64 (4x4 kernels, stride 2, "SAME") ->
500 -> z 40, a decoder 40 -> 7x7x64 -> 14x14x32 -> 28x28x1 by transposed
convolutions (reference :56-91), a Bernoulli likelihood, ``elbo(...)
.sgvb()`` with Adam 1e-3 at batch 128 (reference :120-122), at most 300
steps an epoch. The layers are :mod:`..utils.nn`'s ``conv_apply`` and
``deconv_apply`` (``lax``'s convolutions, held to them layer by layer).

Keys: ``build_q`` and ``elbo_loss`` take ``key``, an int seed of the
variational net's generators; ``noise={"z": eps}`` replaces the ``z``
node's standard normals (a testing hook).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.variational_autoencoders.vae_conv
"""

from __future__ import annotations

import argparse
import time

import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import (
    conv_apply,
    deconv_apply,
    init_conv,
    init_linear,
    linear_apply,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import elbo

__all__ = ["MAX_STEPS_PER_EPOCH", "init_params", "encoder",
           "decoder_logits", "build_gen", "build_q", "elbo_loss",
           "make_train_step", "main"]

MAX_STEPS_PER_EPOCH = 300  # reference vae_conv.py:124


def init_params(generator, z_dim=40, dtype=torch.float32):
    """He-normal parameters drawn from ``generator`` in the JAX example's
    order (its ``init_params``), conv kernels in OIHW."""
    g = generator
    return {
        "e_conv1": init_conv(g, 4, 4, 1, 32, dtype),
        "e_conv2": init_conv(g, 4, 4, 32, 64, dtype),
        "e_fc": init_linear(g, 7 * 7 * 64, 500, dtype),
        "z_mean": init_linear(g, 500, z_dim, dtype),
        "z_logstd": init_linear(g, 500, z_dim, dtype),
        "d_fc": init_linear(g, z_dim, 7 * 7 * 64, dtype),
        "d_deconv1": init_conv(g, 4, 4, 64, 32, dtype),
        "d_deconv2": init_conv(g, 4, 4, 32, 1, dtype),
    }


def decoder_logits(params, z):
    """z -> fc -> 7x7x64 -> deconv s2 -> 14x14x32 -> deconv s2 -> 784
    logits (channels-last, as the JAX example flattens them)."""
    h = torch.relu(linear_apply(params["d_fc"], z))
    h = h.reshape(tuple(h.shape[:-1]) + (7, 7, 64))
    h = torch.relu(deconv_apply(params["d_deconv1"], h, stride=2))
    h = deconv_apply(params["d_deconv2"], h, stride=2)
    return h.reshape(tuple(h.shape[:-3]) + (784,))


def encoder(params, x):
    """784 -> 28x28x1 -> conv s2 -> 14x14x32 -> conv s2 -> 7x7x64 -> 500
    relu features."""
    h = x.reshape(tuple(x.shape[:-1]) + (28, 28, 1))
    h = torch.relu(conv_apply(params["e_conv1"], h, stride=2))
    h = torch.relu(conv_apply(params["e_conv2"], h, stride=2))
    h = h.reshape(tuple(h.shape[:-3]) + (7 * 7 * 64,))
    return torch.relu(linear_apply(params["e_fc"], h))


def build_gen(params, n, z_dim, n_particles):
    """p(z) p(x|z) with the deconv decoder, in the parameters' dtype."""
    w = params["d_fc"]["w"]

    @meta_bayesian_net()
    def gen():
        bn = BayesianNet()
        z = bn.normal("z", torch.zeros([n, z_dim], dtype=w.dtype,
                                       device=w.device),
                      std=1.0, group_ndims=1, n_samples=n_particles)
        x_logits = decoder_logits(params, z.tensor)
        bn.deterministic("x_mean", torch.sigmoid(x_logits))
        bn.bernoulli("x", x_logits, group_ndims=1, dtype=torch.float32)
        return bn

    return gen()


def build_q(params, x, z_dim, n_particles, key, noise=None):
    """q(z|x) with the conv encoder."""
    bn = BayesianNet(key=key, noise=noise)
    h = encoder(params, x)
    z_mean = linear_apply(params["z_mean"], h)
    z_logstd = linear_apply(params["z_logstd"], h)
    bn.normal("z", z_mean, logstd=z_logstd, group_ndims=1,
              n_samples=n_particles)
    return bn


def elbo_loss(params, x, key, z_dim, n_particles=1, noise=None):
    """The negative ELBO, mean over the batch (the SGVB surrogate)."""
    n = x.shape[0]
    variational = build_q(params, x, z_dim, n_particles, key, noise=noise)
    model = build_gen(params, n, z_dim, n_particles)
    lower_bound = elbo(model, {"x": x}, variational=variational, axis=0)
    return torch.mean(lower_bound.sgvb())


def make_train_step(optimizer, z_dim, n_particles=1):
    """One SGVB step: ``train_step(params, x, key, noise=None) -> lower
    bound`` (detached, no host sync)."""

    def train_step(params, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = elbo_loss(params, x, key, z_dim, n_particles, noise=noise)
        loss.backward()
        optimizer.step()
        return -loss.detach()

    return train_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--z_dim", default=40, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    from zhusuan_tpu_torch.examples.utils.dataset import (
        epoch_batches,
        load_binary_mnist,
    )

    x_train, _, _, synthetic = load_binary_mnist()
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    x_train_d = torch.as_tensor(x_train, device=device)
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         hps.z_dim)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3)
    train_step = make_train_step(optimizer, hps.z_dim)
    generator = torch.Generator().manual_seed(1234)
    for epoch in range(1, hps.epochs + 1):
        t0 = time.perf_counter()
        batches = torch.as_tensor(epoch_batches(
            x_train.shape[0], hps.batch_size, epoch, MAX_STEPS_PER_EPOCH),
            device=device)
        lbs = torch.empty(len(batches), device=device)
        for i, (idx, key) in enumerate(zip(
                batches, draw_keys(generator, len(batches)))):
            lbs[i] = train_step(params, x_train_d[idx], key)
        print("Epoch {} ({:.1f}s): Lower bound = {:.4f}".format(
            epoch, time.perf_counter() - t0, float(lbs.mean())))
    return params


if __name__ == "__main__":
    main()
