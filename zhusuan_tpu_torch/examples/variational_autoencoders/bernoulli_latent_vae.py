"""VAE with a binary latent code, trained by REINFORCE with a neural
baseline.

Port of ``examples/variational_autoencoders/bernoulli_latent_vae.py``
(parity: reference ``examples/variational_autoencoders/
bernoulli_latent_vae.py``): a 784-500-500 relu encoder to the logits of 40
Bernoulli latents, a 40-500-500-784 decoder, a Bernoulli likelihood, the
score-function estimator ``elbo(...).reinforce(baseline=c(x),
moving_mean=...)`` with an input-dependent baseline 784-100-1 (reference
:82-90), Adam 1e-3 at batch 128. The moving-average center is explicit
state threaded through the step.

Keys: a function that builds the variational net takes ``key``, an int
seed of its per-node generators; ``noise={"z": u}`` replaces the ``z``
node's uniforms (a testing hook).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.variational_autoencoders.bernoulli_latent_vae
"""

from __future__ import annotations

import argparse
import time

import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import (
    init_linear,
    init_mlp,
    mlp_apply,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import elbo

__all__ = ["build_gen", "build_q", "baseline_net", "init_params", "loss_fn",
           "make_train_step", "main"]


def build_gen(params, x_dim, z_dim, n, n_particles):
    """p(z) p(x|z): ``z`` Bernoulli with logits 0, the decoder's logits for
    ``x`` (float samples, in the parameters' dtype)."""
    w = params["decoder"][0]["w"]

    @meta_bayesian_net()
    def gen():
        bn = BayesianNet()
        z = bn.bernoulli("z", torch.zeros([n, z_dim], dtype=w.dtype,
                                          device=w.device),
                         group_ndims=1, n_samples=n_particles,
                         dtype=w.dtype)
        h = mlp_apply(params["decoder"], z.tensor)
        bn.bernoulli("x", h, group_ndims=1, dtype=torch.float32)
        return bn

    return gen()


def build_q(params, x, z_dim, n_particles, key, noise=None):
    """q(z|x): the encoder's relu features to the latents' logits."""
    bn = BayesianNet(key=key, noise=noise)
    h = mlp_apply(params["encoder"], x, final_activation=torch.relu)
    z_logits = mlp_apply([params["z_logits"]], h)
    bn.bernoulli("z", z_logits, group_ndims=1, n_samples=n_particles,
                 dtype=x.dtype)
    return bn


def baseline_net(params, x):
    """The input-dependent baseline c(x) (reference :76-80)."""
    return mlp_apply(params["baseline"], x).squeeze(-1)


def init_params(generator, x_dim=784, z_dim=40, hidden=500,
                dtype=torch.float32):
    """He-normal parameters drawn from ``generator`` in turn: the decoder,
    the encoder, the latents' logits, the baseline."""
    return {
        "decoder": init_mlp(generator, [z_dim, hidden, hidden, x_dim],
                            dtype),
        "encoder": init_mlp(generator, [x_dim, hidden, hidden], dtype),
        "z_logits": init_linear(generator, hidden, z_dim, dtype),
        "baseline": init_mlp(generator, [x_dim, 100, 1], dtype),
    }


def loss_fn(params, moving_mean, x, key, z_dim, n_particles=1, noise=None):
    """``(mean(cost + baseline_cost), (mean lower bound, new moving
    mean))``: the REINFORCE surrogate and the baseline's regression
    cost."""
    n = x.shape[0]
    variational = build_q(params, x, z_dim, n_particles, key, noise=noise)
    model = build_gen(params, x.shape[-1], z_dim, n, n_particles)
    lower_bound = elbo(model, {"x": x}, variational=variational, axis=0)
    cx = baseline_net(params, x)
    cost, baseline_cost, new_mm = lower_bound.reinforce(
        baseline=cx, moving_mean=moving_mean)
    return torch.mean(cost + baseline_cost), (torch.mean(lower_bound.tensor),
                                              new_mm)


def make_train_step(optimizer, z_dim, n_particles=1):
    """One step: ``train_step(params, moving_mean, x, key, noise=None) ->
    (new moving mean, lower bound)``, both detached (no host sync)."""

    def train_step(params, moving_mean, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss, (lb, new_mm) = loss_fn(params, moving_mean, x, key, z_dim,
                                     n_particles, noise=noise)
        loss.backward()
        optimizer.step()
        return new_mm.detach(), lb.detach()

    return train_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
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
    x_dim, z_dim = 784, 40
    x_train_d = torch.as_tensor(x_train, device=device)
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         x_dim, z_dim)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3)
    train_step = make_train_step(optimizer, z_dim)
    generator = torch.Generator().manual_seed(1234)
    moving_mean = torch.zeros((), device=device)

    for epoch in range(1, hps.epochs + 1):
        t0 = time.perf_counter()
        batches = torch.as_tensor(epoch_batches(
            x_train.shape[0], hps.batch_size, epoch), device=device)
        lbs = torch.empty(len(batches), device=device)
        for i, (idx, key) in enumerate(zip(
                batches, draw_keys(generator, len(batches)))):
            moving_mean, lbs[i] = train_step(params, moving_mean,
                                             x_train_d[idx], key)
        print("Epoch {} ({:.1f}s): Lower bound = {:.4f}".format(
            epoch, time.perf_counter() - t0, float(lbs.mean())))
    return params


if __name__ == "__main__":
    main()
