"""Wasserstein GAN with weight clipping.

Port of ``examples/generative_adversarial_nets/wasserstein_gan.py``
(reference ``examples/generative_adversarial_nets/wasserstein_gan.py``):
DCGAN's generator-as-BayesianNet (:mod:`.dcgan`), the critic loss
``mean(f(fake)) - mean(f(real))``, RMSProp optimizers, the critic's
weights clipped to ``[-clip, clip]`` after each of its ``n_critic`` updates
a generator update.

RMSProp: ``optax.rmsprop(lr)`` decays the squares by 0.9 and adds ``eps =
1e-8`` inside the square root; ``torch.optim.RMSprop`` adds it outside (and
decays by 0.99), so the example takes the port's copy of optax's rule
(:class:`~zhusuan_tpu_torch.examples.utils.optimizers.RMSProp`).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.generative_adversarial_nets.wasserstein_gan
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.generative_adversarial_nets.dcgan import (
    discriminator,
    generator,
    init_params,
    load_train_images,
)
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.optimizers import RMSProp
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.utils import tree_leaves

__all__ = ["critic_loss", "gen_loss", "make_steps", "main"]


def critic_loss(disc_params, gen_params, x_real, key, z_dim, noise=None):
    n = x_real.shape[0]
    x_gen = generator(gen_params, n, z_dim, key, noise)["x_gen"]
    return (torch.mean(discriminator(disc_params, x_gen))
            - torch.mean(discriminator(disc_params, x_real)))


def gen_loss(gen_params, disc_params, x_real, key, z_dim, noise=None):
    n = x_real.shape[0]
    x_gen = generator(gen_params, n, z_dim, key, noise)["x_gen"]
    return -torch.mean(discriminator(disc_params, x_gen))


def make_steps(gen_params, disc_params, z_dim, lr=5e-5, clip=0.01):
    """``(critic_step, gen_step)`` (``wasserstein_gan.py:66-86``), each
    ``(x, key, noise=None) -> loss``, updating the parameters in place: the
    critic's RMSProp step then the clip of its weights, the generator's
    RMSProp step."""
    d_opt = RMSProp(tree_leaves(disc_params), lr=lr)
    g_opt = RMSProp(tree_leaves(gen_params), lr=lr)

    def critic_step(x, key=None, noise=None):
        d_opt.zero_grad(set_to_none=True)
        loss = critic_loss(disc_params, gen_params, x, key, z_dim, noise)
        grads = torch.autograd.grad(loss, tree_leaves(disc_params))
        for p, g in zip(tree_leaves(disc_params), grads):
            p.grad = g
        d_opt.step()
        # Weight clipping enforces the Lipschitz constraint.
        with torch.no_grad():
            for p in tree_leaves(disc_params):
                p.clamp_(-clip, clip)
        return loss.detach()

    def gen_step(x, key=None, noise=None):
        g_opt.zero_grad(set_to_none=True)
        loss = gen_loss(gen_params, disc_params, x, key, z_dim, noise)
        grads = torch.autograd.grad(loss, tree_leaves(gen_params))
        for p, g in zip(tree_leaves(gen_params), grads):
            p.grad = g
        g_opt.step()
        return loss.detach()

    return critic_step, gen_step


def main(epochs=5, batch_size=64, z_dim=40, n_critic=5, clip=0.01, ngf=64,
         ndf=32, lr=5e-5, x_train=None, iters_per_epoch=50, device=None,
         seed=1234, verbose=True):
    """The WGAN training loop (reference wasserstein_gan.py:72-117).
    Returns ``(gen_params, disc_params, history)`` with the per-epoch mean
    W-distance estimates and generator losses."""
    device = torch.device("cuda:0" if device is None else device)
    if x_train is None:
        x_train = load_train_images(verbose)
    x_dev = torch.as_tensor(np.asarray(x_train, np.float32), device=device)
    gen_params, disc_params = init_params(seed, z_dim, ngf, ndf, device)
    critic_step, gen_step = make_steps(gen_params, disc_params, z_dim, lr,
                                       clip)
    host = torch.Generator().manual_seed(seed)
    iters = min(x_dev.shape[0] // batch_size, iters_per_epoch)
    history = {"w_dist": [], "gen_loss": []}
    for epoch in range(1, epochs + 1):
        perm = np.random.RandomState(epoch).permutation(x_dev.shape[0])
        w_dists, gls = [], []
        for t in range(iters):
            x = x_dev[torch.as_tensor(
                perm[t * batch_size:(t + 1) * batch_size], device=device)]
            keys = draw_keys(host, n_critic + 1)
            for key in keys[:-1]:
                closs = critic_step(x, key)
            gls.append(gen_step(x, keys[-1]))
            w_dists.append(-closs)
        history["w_dist"].append(float(torch.stack(w_dists).mean()))
        history["gen_loss"].append(float(torch.stack(gls).mean()))
        if verbose:
            print("Epoch {}: W-distance est = {:.4f}, gen loss = {:.4f}"
                  .format(epoch, history["w_dist"][-1],
                          history["gen_loss"][-1]))
    return gen_params, disc_params, history


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=5)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(args.epochs, device=resolve_device(args.device))


if __name__ == "__main__":
    _cli()
