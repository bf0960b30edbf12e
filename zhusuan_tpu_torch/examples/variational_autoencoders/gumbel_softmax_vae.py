"""Categorical-latent VAE trained through the Gumbel-softmax (ExpConcrete)
relaxation (Maddison et al. 2017; Jang et al. 2017).

Port of ``examples/variational_autoencoders/gumbel_softmax_vae.py``: 20
categorical variables of 10 classes each, relaxed in log-simplex space
(``ExpConcrete``, ``group_ndims=2``) in both the prior (uniform logits) and
the posterior (a 784-400 relu encoder to the logits), a 200-400-784 decoder
on ``exp(z)``, a Bernoulli likelihood, plain SGVB with Adam 1e-3 at batch
128. The relaxation's temperature anneals from 1.0 to 0.5 over the epochs.

As in the JAX example, ``group_ndims=2`` on a latent of batch shape ``[n,
n_vars]`` groups the batch axis too: ``log p(z)`` and ``log q(z|x)`` are
summed over the minibatch and added to every row's likelihood term, and
the example runs with one particle (a second particle axis does not
broadcast against the likelihood's ``[n_particles, n]``).

Keys: ``build_q`` and ``loss_fn`` take ``key``, an int seed of the
variational net's generators; ``noise={"z": u}`` replaces the ``z`` node's
open-interval uniforms (a testing hook).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.variational_autoencoders.gumbel_softmax_vae
"""

from __future__ import annotations

import argparse

import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import (
    init_linear,
    init_mlp,
    linear_apply,
    mlp_apply,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import elbo

__all__ = ["build_gen", "build_q", "init_params", "loss_fn", "temperature",
           "make_train_step", "main"]


def build_gen(params, n_vars, n_classes, n, temperature, n_particles):
    """p(z) p(x|z): a uniform relaxed prior (logits 0 in the temperature's
    dtype) and the decoder on ``exp(z)`` flattened."""
    temperature = torch.as_tensor(temperature)

    @meta_bayesian_net()
    def gen():
        bn = BayesianNet()
        z = bn.exp_concrete(
            "z", temperature,
            torch.zeros([n, n_vars, n_classes], dtype=temperature.dtype,
                        device=temperature.device),
            group_ndims=2, n_samples=n_particles)
        flat = torch.exp(z.tensor).reshape(
            tuple(z.tensor.shape[:-2]) + (n_vars * n_classes,))
        h = mlp_apply(params["decoder"], flat)
        bn.bernoulli("x", h, group_ndims=1, dtype=torch.float32)
        return bn

    return gen()


def build_q(params, x, n_vars, n_classes, temperature, n_particles, key,
            noise=None):
    """q(z|x): the encoder's relu features to ``[n, n_vars, n_classes]``
    logits of an ExpConcrete."""
    bn = BayesianNet(key=key, noise=noise)
    h = mlp_apply(params["encoder"], x, final_activation=torch.relu)
    logits = linear_apply(params["z_logits"], h).reshape(
        tuple(x.shape[:-1]) + (n_vars, n_classes))
    bn.exp_concrete("z", temperature, logits, group_ndims=2,
                    n_samples=n_particles)
    return bn


def init_params(generator, x_dim=784, n_vars=20, n_classes=10, hidden=400,
                dtype=torch.float32):
    """He-normal parameters drawn from ``generator`` in turn: the decoder,
    the encoder, the latents' logits."""
    code = n_vars * n_classes
    return {
        "decoder": init_mlp(generator, [code, hidden, x_dim], dtype),
        "encoder": init_mlp(generator, [x_dim, hidden], dtype),
        "z_logits": init_linear(generator, hidden, code, dtype),
    }


def loss_fn(params, x, key, n_vars, n_classes, temperature, n_particles=1,
            noise=None):
    """``(mean SGVB surrogate, mean relaxed lower bound)``."""
    n = x.shape[0]
    variational = build_q(params, x, n_vars, n_classes, temperature,
                          n_particles, key, noise=noise)
    model = build_gen(params, n_vars, n_classes, n, temperature,
                      n_particles)
    lower_bound = elbo(model, {"x": x}, variational=variational, axis=0)
    return torch.mean(lower_bound.sgvb()), torch.mean(lower_bound.tensor)


def temperature(epoch, epochs, device=None):
    """The annealed temperature of 0-based ``epoch``: 1.0 down to 0.5 at
    the last epoch, in float32."""
    return torch.tensor(1.0 - 0.5 * epoch / max(epochs - 1, 1),
                        dtype=torch.float32, device=device)


def make_train_step(optimizer, n_vars, n_classes, n_particles=1):
    """One step: ``train_step(params, x, key, temperature, noise=None) ->
    relaxed lower bound`` (detached, no host sync)."""

    def train_step(params, x, key, temp, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss, lb = loss_fn(params, x, key, n_vars, n_classes, temp,
                           n_particles, noise=noise)
        loss.backward()
        optimizer.step()
        return lb.detach()

    return train_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--n_vars", default=20, type=int)
    parser.add_argument("--n_classes", default=10, type=int)
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
                         x_train.shape[-1], hps.n_vars, hps.n_classes)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3)
    train_step = make_train_step(optimizer, hps.n_vars, hps.n_classes)
    generator = torch.Generator().manual_seed(1234)
    for epoch in range(hps.epochs):
        tau = temperature(epoch, hps.epochs, device)
        batches = torch.as_tensor(epoch_batches(
            x_train.shape[0], hps.batch_size, epoch), device=device)
        lbs = torch.empty(len(batches), device=device)
        for j, (idx, key) in enumerate(zip(
                batches, draw_keys(generator, len(batches)))):
            lbs[j] = train_step(params, x_train_d[idx], key, tau)
        print("Epoch {}: tau {:.2f}, relaxed lower bound = {:.2f}".format(
            epoch + 1, float(tau), float(lbs.mean())))
    return params


if __name__ == "__main__":
    main()
