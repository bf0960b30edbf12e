"""Semi-supervised VAE (Kingma's M2 model).

Port of ``examples/semi_supervised_vae/vae_ssl.py`` (parity: reference
``examples/semi_supervised_vae/vae_ssl.py``): p(z) p(y) p(x | z, y) with a
500-unit decoder, q(z | x, y) and a classifier q(y | x); the labeled ELBO,
plus the unlabeled ELBO with y marginalized over every class, plus the
classifier's cost scaled by ``beta`` = 1200 (reference :95-133). 100
labeled rows (10 a class), batches of 100 unlabeled rows, 10 particles,
z_dim 100, Adam(3e-4), at most 200 steps an epoch; every row is binarized
anew each step.

Keys: a builder that draws takes ``key``, an int seed of its nodes'
generators (``noise=`` replaces their draws, a testing hook); a step takes
one key a net; the loop draws them from a CPU ``torch.Generator``.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.semi_supervised_vae.vae_ssl
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.distributions import OnehotCategorical
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

__all__ = ["build_gen", "qz_xy", "qy_x", "init_params", "ssl_cost",
           "classifier_terms", "make_train_step", "binarize_batches",
           "run_epoch", "main"]


def build_gen(params, n, x_dim, n_class, z_dim, n_particles):
    """p(z) p(y) p(x | z, y) (reference vae_ssl.py:20-33), in the
    parameters' dtype and on their device."""
    w = params["gen_z_h"]["w"]

    @meta_bayesian_net()
    def gen():
        bn = BayesianNet()
        z = bn.normal("z", torch.zeros([n, z_dim], dtype=w.dtype,
                                       device=w.device),
                      std=1.0, group_ndims=1, n_samples=n_particles)
        h_from_z = linear_apply(params["gen_z_h"], z.tensor)
        y = bn.onehot_categorical(
            "y", torch.zeros([n, n_class], dtype=w.dtype, device=w.device),
            dtype=w.dtype)
        h_from_y = linear_apply(params["gen_y_h"], y.tensor)
        h = torch.relu(h_from_z + h_from_y)
        h = torch.relu(linear_apply(params["gen_h_h"], h))
        x_logits = linear_apply(params["gen_h_x"], h)
        bn.bernoulli("x", x_logits, group_ndims=1, dtype=w.dtype)
        return bn

    return gen()


def qz_xy(params, x, y, z_dim, n_particles, key, noise=None):
    """q(z | x, y) (reference vae_ssl.py:36-46); ``noise={"z": eps}``."""
    bn = BayesianNet(key=key, noise=noise)
    h = torch.cat([x, y], -1)
    h = mlp_apply(params["qz_net"], h, final_activation=torch.relu)
    bn.normal("z", linear_apply(params["qz_mean"], h),
              logstd=linear_apply(params["qz_logstd"], h), group_ndims=1,
              n_samples=n_particles)
    return bn


def qy_x(params, x, n_class):
    """Classifier logits q(y | x) (reference vae_ssl.py:49-54)."""
    return mlp_apply(params["classifier"], x)


def init_params(generator, x_dim, n_class, z_dim, hidden=500,
                dtype=torch.float32):
    """He-normal layers drawn in turn from ``generator`` (on the device
    they go to): the decoder's four, the encoder's, then the
    classifier's."""
    return {
        "gen_z_h": init_linear(generator, z_dim, hidden, dtype),
        "gen_y_h": init_linear(generator, n_class, hidden, dtype),
        "gen_h_h": init_linear(generator, hidden, hidden, dtype),
        "gen_h_x": init_linear(generator, hidden, x_dim, dtype),
        "qz_net": init_mlp(generator, [x_dim + n_class, hidden, hidden],
                           dtype),
        "qz_mean": init_linear(generator, hidden, z_dim, dtype),
        "qz_logstd": init_linear(generator, hidden, z_dim, dtype),
        "classifier": init_mlp(generator, [x_dim, hidden, hidden, n_class],
                               dtype),
    }


def classifier_terms(params, x_l, y_l, n_class, beta):
    """``(beta-scaled classifier cost, training accuracy)`` on the labeled
    rows."""
    qy_logits_l = qy_x(params, x_l, n_class)
    log_qy_x = OnehotCategorical(qy_logits_l, dtype=x_l.dtype).log_prob(y_l)
    acc = torch.mean((torch.argmax(qy_logits_l, -1)
                      == torch.argmax(y_l, -1)).to(torch.float32))
    return -beta * torch.mean(log_qy_x), acc


def ssl_cost(params, x_l, y_l, x_u, keys, n_class, z_dim, n_particles, beta,
             noise=None):
    """``(cost, (labeled lb, unlabeled lb, accuracy))``: labeled ELBO +
    unlabeled ELBO marginalizing y over every class + classifier cost
    (reference vae_ssl.py:95-133).

    :param keys: ``(k_l, k_u)``, the labeled and unlabeled nets' seeds.
    :param noise: ``(noise_l, noise_u)``, each ``{"z": eps}`` (testing
        hook).
    """
    k_l, k_u = keys
    noise_l, noise_u = noise if noise is not None else (None, None)
    x_dim = x_l.shape[-1]

    n_l = x_l.shape[0]
    variational_l = qz_xy(params, x_l, y_l, z_dim, n_particles, k_l,
                          noise=noise_l)
    model_l = build_gen(params, n_l, x_dim, n_class, z_dim, n_particles)
    labeled_lb = torch.mean(elbo(model_l, {"x": x_l, "y": y_l},
                                 variational=variational_l, axis=0).tensor)

    # Unlabeled term: each row tiled over every class.
    n_u = x_u.shape[0]
    y_u = torch.eye(n_class, dtype=x_u.dtype,
                    device=x_u.device).repeat(n_u, 1)
    x_tiled = x_u[:, None, :].expand(n_u, n_class, x_dim).reshape(-1, x_dim)
    variational_u = qz_xy(params, x_tiled, y_u, z_dim, n_particles, k_u,
                          noise=noise_u)
    model_u = build_gen(params, n_u * n_class, x_dim, n_class, z_dim,
                        n_particles)
    lb_z = elbo(model_u, {"x": x_tiled, "y": y_u},
                variational=variational_u, axis=0).tensor
    lb_z = lb_z.reshape(-1, n_class)
    qy_u = torch.softmax(qy_x(params, x_u, n_class), -1) + 1e-8
    qy_u = qy_u / torch.sum(qy_u, -1, keepdim=True)
    unlabeled_lb = torch.mean(torch.sum(qy_u * (lb_z - torch.log(qy_u)),
                                        -1))

    classifier_cost, acc = classifier_terms(params, x_l, y_l, n_class, beta)
    cost = -(labeled_lb + unlabeled_lb) + classifier_cost
    return cost, (labeled_lb, unlabeled_lb, acc)


def make_train_step(cost_fn, optimizer, n_class, z_dim, n_particles, beta):
    """One Adam step of ``cost_fn`` (:func:`ssl_cost` or the adaptive-IS
    cost): ``train_step(params, x_l, y_l, x_u, keys, noise=None) ->
    [labeled lb, unlabeled lb, accuracy]`` (a detached tensor, no host
    sync)."""

    def train_step(params, x_l, y_l, x_u, keys, noise=None):
        optimizer.zero_grad(set_to_none=True)
        cost, aux = cost_fn(params, x_l, y_l, x_u, keys, n_class, z_dim,
                            n_particles, beta, noise=noise)
        cost.backward()
        optimizer.step()
        return torch.stack([a.detach().to(torch.float32) for a in aux])

    return train_step


def binarize_batches(x_unlabeled, batch_size, epoch, n_steps):
    """The epoch's unlabeled batches, binarized on the host as the JAX
    example does (``RandomState(epoch)`` permutation, ``RandomState(epoch
    * 1000 + t)`` pixels): ``[n_steps, batch_size, x_dim]`` float32."""
    perm = np.random.RandomState(epoch).permutation(x_unlabeled.shape[0])
    out = np.empty((n_steps, batch_size, x_unlabeled.shape[1]), np.float32)
    for t in range(n_steps):
        rows = x_unlabeled[perm[t * batch_size:(t + 1) * batch_size]]
        out[t] = np.random.RandomState(epoch * 1000 + t).rand(
            *rows.shape) < rows
    return out


def run_epoch(train_step, params, x_labeled, t_labeled, x_unlabeled,
              batch_size, epoch, generator, max_steps=200):
    """One epoch: ``min(n_unlabeled // batch_size, max_steps)`` steps, the
    labeled rows binarized on the card each step from the step's first
    key. Returns the per-step ``[labeled lb, unlabeled lb, accuracy]``
    rows as a ``[n_steps, 3]`` device tensor (no host sync)."""
    device = x_labeled.device
    n_steps = min(x_unlabeled.shape[0] // batch_size, max_steps)
    x_u_all = torch.as_tensor(binarize_batches(
        x_unlabeled, batch_size, epoch, n_steps), device=device)
    stats = torch.empty((n_steps, 3), device=device)
    keys = draw_keys(generator, 3 * n_steps)
    for t in range(n_steps):
        k_bin, k_l, k_u = keys[3 * t:3 * t + 3]
        g = torch.Generator(device=device).manual_seed(k_bin)
        x_l = (torch.rand(x_labeled.shape, generator=g, device=device)
               < x_labeled).to(torch.float32)
        stats[t] = train_step(params, x_l, t_labeled, x_u_all[t],
                              (k_l, k_u))
    return stats


def main(argv=None, cost_fn=None, description=None):
    parser = argparse.ArgumentParser(
        description=description or __doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=100, type=int)
    parser.add_argument("--lb_samples", default=10, type=int)
    parser.add_argument("--z_dim", default=100, type=int)
    parser.add_argument("--beta", default=1200.0, type=float)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    from zhusuan_tpu_torch.examples.utils.dataset import (
        load_mnist_semi_supervised,
    )

    n_class = 10
    x_labeled, t_labeled, x_unlabeled, _, _, synthetic = \
        load_mnist_semi_supervised(n_labeled=100)
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    x_dim = x_labeled.shape[1]
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         x_dim, n_class, hps.z_dim)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=3e-4)
    train_step = make_train_step(cost_fn or ssl_cost, optimizer, n_class,
                                 hps.z_dim, hps.lb_samples, hps.beta)
    x_l = torch.as_tensor(x_labeled, device=device)
    y_l = torch.as_tensor(t_labeled, device=device)
    generator = torch.Generator().manual_seed(1234)
    for epoch in range(1, hps.epochs + 1):
        stats = run_epoch(train_step, params, x_l, y_l, x_unlabeled,
                          hps.batch_size, epoch, generator)
        lb_l, lb_u, acc = stats.mean(0).tolist()
        print("Epoch {}: labeled lb = {:.2f}, unlabeled lb = {:.2f}, "
              "train acc = {:.4f}".format(epoch, lb_l, lb_u, acc))
    return params


if __name__ == "__main__":
    main()
