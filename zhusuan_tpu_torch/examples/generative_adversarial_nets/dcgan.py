"""DCGAN: the generator is a BayesianNet with a uniform noise node.

Port of ``examples/generative_adversarial_nets/dcgan.py`` (reference
``examples/generative_adversarial_nets/dcgan.py``: a generator with
``bn.uniform`` noise at :20-41, a conv discriminator, the non-saturating
GAN losses). As in the JAX package, batch norm is replaced by bias-free
conv + relu. The layers are :mod:`..utils.nn`'s ``linear_apply``,
``conv_apply`` and ``deconv_apply`` (``lax``'s convolutions, channels
last); both optimizers are Adam with ``b1 = 0.5`` (``optax.adam(lr,
b1=0.5)``, which ``torch.optim.Adam(betas=(0.5, 0.999))`` computes).

Keys: the generator's net takes ``key``, an int seed of its node
generators; ``noise={"z": u}`` replaces the ``z`` node's uniforms on [0, 1)
(``z = 2 u - 1``; a testing hook). CIFAR-10 is replaced by its loader's
synthetic images when absent.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.generative_adversarial_nets.dcgan
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import (
    conv_apply,
    deconv_apply,
    init_conv,
    init_linear,
    linear_apply,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet
from zhusuan_tpu_torch.utils import tree_leaves

__all__ = ["init_gen_params", "init_disc_params", "init_params",
           "generator", "discriminator", "gan_losses", "synthetic_cifar",
           "load_train_images", "make_train_step", "main"]


def init_gen_params(generator, z_dim, ngf=64, dtype=torch.float32):
    g = generator
    return {
        "fc": init_linear(g, z_dim, ngf * 8 * 4 * 4, dtype),
        "deconv1": init_conv(g, 5, 5, ngf * 8, ngf * 4, dtype),
        "deconv2": init_conv(g, 5, 5, ngf * 4, ngf * 2, dtype),
        "deconv3": init_conv(g, 5, 5, ngf * 2, 3, dtype),
    }


def init_disc_params(generator, ndf=32, dtype=torch.float32):
    g = generator
    return {
        "conv1": init_conv(g, 5, 5, 3, ndf * 2, dtype),
        "conv2": init_conv(g, 5, 5, ndf * 2, ndf * 4, dtype),
        "conv3": init_conv(g, 5, 5, ndf * 4, ndf * 8, dtype),
        "fc": init_linear(g, ndf * 8 * 4 * 4, 1, dtype),
    }


def init_params(seed, z_dim, ngf, ndf, device=None):
    """``(gen_params, disc_params)`` drawn from a generator on ``device``
    seeded by ``seed`` (the training loops' start)."""
    g = torch.Generator(device=device or "cpu").manual_seed(int(seed))
    return init_gen_params(g, z_dim, ngf=ngf), init_disc_params(g, ndf=ndf)


def generator(params, n, z_dim, key=None, noise=None):
    """The generator as a BayesianNet with a uniform ``z`` node (reference
    dcgan.py:18-39); ``x_gen [n, 32, 32, 3]`` is its deterministic
    node."""
    kw = dict(dtype=params["fc"]["w"].dtype, device=params["fc"]["w"].device)
    bn = BayesianNet(key=key, noise=noise)
    z = bn.uniform("z", -torch.ones((n, z_dim), **kw),
                   torch.ones((n, z_dim), **kw))
    h = torch.relu(linear_apply(params["fc"], z.tensor))
    ngf8 = params["fc"]["b"].shape[0] // 16  # fc out = ngf*8 * 4 * 4
    h = h.reshape(-1, 4, 4, ngf8)
    h = torch.relu(deconv_apply(params["deconv1"], h, stride=2))
    h = torch.relu(deconv_apply(params["deconv2"], h, stride=2))
    x = torch.sigmoid(deconv_apply(params["deconv3"], h, stride=2))
    bn.deterministic("x_gen", x)
    return bn


def discriminator(params, x):
    h = F.leaky_relu(conv_apply(params["conv1"], x, stride=2))
    h = F.leaky_relu(conv_apply(params["conv2"], h, stride=2))
    h = F.leaky_relu(conv_apply(params["conv3"], h, stride=2))
    h = h.reshape(h.shape[0], -1)
    return linear_apply(params["fc"], h)


def _bce(logits, target):
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_losses(gen_params, disc_params, x_real, key, z_dim, noise=None):
    """The non-saturating GAN losses ``(gen_loss, disc_loss)`` (reference
    dcgan.py:80-96)."""
    n = x_real.shape[0]
    x_gen = generator(gen_params, n, z_dim, key, noise)["x_gen"]
    real_logits = discriminator(disc_params, x_real)
    fake_logits = discriminator(disc_params, x_gen)
    gen_loss = _bce(fake_logits, 1.0)
    disc_loss = _bce(real_logits, 1.0) + _bce(fake_logits, 0.0)
    return gen_loss, disc_loss


def synthetic_cifar(n=10000, seed=0):
    """A small CIFAR-shaped set (the JAX example's ``RandomState``
    draws)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(10, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, n)
    return base[labels] * 0.7 + 0.3 * rng.rand(n, 32, 32, 3).astype(
        np.float32)


def load_train_images(verbose=True):
    """The first 10000 CIFAR-10 training images in [0, 1] (synthetic when
    the files are absent)."""
    from zhusuan_tpu_torch.examples.utils.dataset import load_cifar10

    x_train, _, _, _, synthetic = load_cifar10(normalize=True)
    if synthetic and verbose:
        print("[note] CIFAR-10 not found; using synthetic CIFAR-shaped "
              "data.")
    return x_train[:10000]


def _set_grads(params, grads):
    for p, g in zip(tree_leaves(params), grads):
        p.grad = g


def make_train_step(gen_params, disc_params, z_dim, lr=2e-4):
    """The training step of both players (``dcgan.py:128-150``): the two
    losses on one draw of ``z``, each player's gradient of its own loss,
    one Adam step each (``b1 = 0.5``). Returns ``step(x, key, noise=None)
    -> (gen_loss, disc_loss)``, updating the parameters in place."""
    g_opt = torch.optim.Adam(tree_leaves(gen_params), lr=lr,
                             betas=(0.5, 0.999))
    d_opt = torch.optim.Adam(tree_leaves(disc_params), lr=lr,
                             betas=(0.5, 0.999))

    def step(x, key=None, noise=None):
        gl, dl = gan_losses(gen_params, disc_params, x, key, z_dim, noise)
        g_grads = torch.autograd.grad(gl, tree_leaves(gen_params),
                                      retain_graph=True)
        d_grads = torch.autograd.grad(dl, tree_leaves(disc_params))
        _set_grads(gen_params, g_grads)
        _set_grads(disc_params, d_grads)
        g_opt.step()
        d_opt.step()
        return gl.detach(), dl.detach()

    return step


def main(epochs=5, batch_size=64, z_dim=40, ngf=64, ndf=32, lr=2e-4,
         x_train=None, iters_per_epoch=100, save_samples=True, device=None,
         seed=1234, verbose=True):
    """The adversarial training loop (reference dcgan.py:99-138). Returns
    ``(gen_params, disc_params, history)`` with the per-epoch mean
    generator and discriminator losses. ``save_samples`` writes a 10 x 10
    grid an epoch under ``results/dcgan/`` (needs PIL)."""
    device = torch.device("cuda:0" if device is None else device)
    if x_train is None:
        x_train = load_train_images(verbose)
    x_dev = torch.as_tensor(np.asarray(x_train, np.float32), device=device)
    gen_params, disc_params = init_params(seed, z_dim, ngf, ndf, device)
    step = make_train_step(gen_params, disc_params, z_dim, lr)
    host = torch.Generator().manual_seed(seed)
    iters = min(x_dev.shape[0] // batch_size, iters_per_epoch)
    history = {"gen_loss": [], "disc_loss": []}
    for epoch in range(1, epochs + 1):
        perm = np.random.RandomState(epoch).permutation(x_dev.shape[0])
        losses = [step(x_dev[torch.as_tensor(
            perm[t * batch_size:(t + 1) * batch_size], device=device)], key)
            for t, key in enumerate(draw_keys(host, iters))]
        gls = torch.stack([v[0] for v in losses]).cpu().numpy()
        dls = torch.stack([v[1] for v in losses]).cpu().numpy()
        history["gen_loss"].append(float(np.mean(gls)))
        history["disc_loss"].append(float(np.mean(dls)))
        if verbose:
            print("Epoch {}: gen loss = {:.4f}, disc loss = {:.4f}".format(
                epoch, np.mean(gls), np.mean(dls)))
        if save_samples:
            from zhusuan_tpu_torch.examples.utils.utils import (
                save_image_collections,
            )

            with torch.no_grad():
                samples = generator(gen_params, 100, z_dim,
                                    draw_keys(host, 1)[0])["x_gen"]
            save_image_collections(
                samples, "results/dcgan/epoch_{}.png".format(epoch))
    return gen_params, disc_params, history


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=5)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(args.epochs, device=resolve_device(args.device))


if __name__ == "__main__":
    _cli()
