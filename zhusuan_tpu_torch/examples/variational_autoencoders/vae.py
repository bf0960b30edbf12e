"""VAE on binarized MNIST: the flagship end-to-end example.

Port of ``examples/variational_autoencoders/vae.py`` (parity: reference
``examples/variational_autoencoders/vae.py``, BASELINE config #3 part 1): a
784-500-500 relu encoder to ``z_mean``/``z_logstd`` (z_dim 40), a
40-500-500-784 decoder, a Bernoulli likelihood, SGVB ELBO training with Adam
1e-3 at batch 128, and the IS log-likelihood at 1000 particles.

Keys: a function that builds a net takes ``key``, an int seed of the
variational net's per-node generators (``noise=`` replaces its draws, a
testing hook: ``{"z": eps}``); a loop takes a CPU ``torch.Generator`` and
draws the keys from it (:func:`~zhusuan_tpu_torch.fit.draw_keys`).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.variational_autoencoders.vae
"""

from __future__ import annotations

import argparse
import time

import torch

from zhusuan_tpu_torch.evaluation import is_loglikelihood
from zhusuan_tpu_torch.examples.utils import protocols
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import (
    init_linear,
    init_mlp,
    mlp_apply,
)
from zhusuan_tpu_torch.fit import draw_keys, fit_scan
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import elbo

__all__ = [
    "build_gen", "build_q", "init_params", "elbo_loss", "iw_log_likelihood",
    "eval_is_loglikelihood", "make_train_step", "fit_loss", "fit_protocol",
    "main",
]


def build_gen(params, x_dim, z_dim, n, n_particles=1):
    """The generative model p(z) p(x|z) (reference vae.py:18-30), in the
    parameters' dtype and on their device."""
    w = params["decoder"][0]["w"]

    @meta_bayesian_net()
    def gen():
        bn = BayesianNet()
        z = bn.normal("z", torch.zeros([n, z_dim], dtype=w.dtype,
                                       device=w.device),
                      std=1.0, group_ndims=1, n_samples=n_particles)
        h = mlp_apply(params["decoder"], z.tensor)
        bn.deterministic("x_mean", torch.sigmoid(h))
        bn.bernoulli("x", h, group_ndims=1, dtype=torch.float32)
        return bn

    return gen()


def build_q(params, x, z_dim, n_particles, key, noise=None):
    """The variational posterior q(z|x) (reference vae.py:33-41: both
    500-unit layers relu-activated). ``key`` seeds the ``z`` node's
    generator; ``noise={"z": eps}`` replaces its standard normals."""
    bn = BayesianNet(key=key, noise=noise)
    h = mlp_apply(params["encoder"], x, final_activation=torch.relu)
    z_mean = mlp_apply([params["z_mean"]], h)
    z_logstd = mlp_apply([params["z_logstd"]], h)
    bn.normal("z", z_mean, logstd=z_logstd, group_ndims=1,
              n_samples=n_particles)
    return bn


def init_params(generator, x_dim=784, z_dim=40, hidden=500,
                dtype=torch.float32):
    """He-normal parameters drawn from ``generator`` (a ``torch.Generator``
    on the device they go to): the decoder, the encoder, then the two
    heads."""
    return {
        "decoder": init_mlp(generator, [z_dim, hidden, hidden, x_dim],
                            dtype),
        "encoder": init_mlp(generator, [x_dim, hidden, hidden], dtype),
        "z_mean": init_linear(generator, hidden, z_dim, dtype),
        "z_logstd": init_linear(generator, hidden, z_dim, dtype),
    }


def elbo_loss(params, x, key, z_dim, n_particles=1, noise=None):
    """Negative ELBO, mean over the batch (the SGVB surrogate)."""
    n = x.shape[0]
    variational = build_q(params, x, z_dim, n_particles, key, noise=noise)
    model = build_gen(params, x.shape[-1], z_dim, n, n_particles)
    lower_bound = elbo(model, {"x": x}, variational=variational, axis=0)
    return torch.mean(lower_bound.sgvb())


def iw_log_likelihood(params, x, key, z_dim, n_particles=1000, noise=None):
    """IS estimate of log p(x) with ``n_particles`` particles, mean over
    the batch (reference vae.py:70-75)."""
    n = x.shape[0]
    variational = build_q(params, x, z_dim, n_particles, key, noise=noise)
    model = build_gen(params, x.shape[-1], z_dim, n, n_particles)
    return torch.mean(is_loglikelihood(model, {"x": x},
                                       proposal=variational, axis=0))


@torch.no_grad()
def eval_is_loglikelihood(params, x, generator, z_dim, n_particles=1000,
                          batch_size=128):
    """Test-set IS log-likelihood over batches of ``batch_size`` rows
    (reference vae.py:98-107), one key a batch from the CPU
    ``generator``; one host read at the end."""
    n = x.shape[0]
    n_batches = (n + batch_size - 1) // batch_size
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i, key in enumerate(draw_keys(generator, n_batches)):
        xb = x[i * batch_size:(i + 1) * batch_size]
        total += iw_log_likelihood(params, xb, key, z_dim,
                                   n_particles) * xb.shape[0]
    return float(total) / n


def make_train_step(optimizer, z_dim, n_particles=1):
    """One SGVB step: ``train_step(params, x, key, noise=None) -> lower
    bound`` (detached, no host sync); ``optimizer`` is a
    ``torch.optim.Optimizer`` over the parameters' leaves."""

    def train_step(params, x, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = elbo_loss(params, x, key, z_dim, n_particles, noise=noise)
        loss.backward()
        optimizer.step()
        return -loss.detach()

    return train_step


def fit_loss(z_dim, n_particles=1, binarize=False):
    """The ``loss_fn(params, batch, generator)`` of
    :func:`~zhusuan_tpu_torch.fit.fit_scan`: the step's generator keys the
    variational net and, with ``binarize``, first draws the batch's dynamic
    binarization ``u < x`` (reference vae.py:58)."""

    def loss_fn(params, batch, generator):
        if binarize:
            u = torch.rand(batch.shape, generator=generator,
                           dtype=batch.dtype, device=batch.device)
            batch = (u < batch).to(batch.dtype)
        return elbo_loss(params, batch, generator.initial_seed(), z_dim,
                         n_particles)

    return loss_fn


def fit_protocol(device, seed=1, epochs=protocols.VAE_EPOCHS,
                 callback=None):
    """The VAE protocol (``baseline_ref/vae_protocol.py``, the JAX side in
    ``baseline_ref/measure_vae_ours.py``): 10k rows of synthetic MNIST, the
    protocol's per-epoch permutations, dynamic binarization, Adam 1e-3,
    batch 128, one :func:`~zhusuan_tpu_torch.fit.fit_scan` epoch at a time.

    :param callback: optional ``(epoch, lower_bound, seconds)`` after each
        epoch (1-based).
    :return: ``(params, curve, epoch_seconds)``: the per-epoch mean
        training lower bound and each epoch's wall seconds (one host read
        each).
    """
    device = torch.device(device)
    x_train = torch.as_tensor(protocols.vae_train_data(), device=device)
    perms = protocols.vae_permutations()
    init_gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(init_gen, x_train.shape[1], protocols.VAE_Z_DIM)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=protocols.VAE_LR)
    generator = torch.Generator().manual_seed(seed)
    loss_fn = fit_loss(protocols.VAE_Z_DIM, binarize=True)
    curve, seconds = [], []
    for epoch in range(1, int(epochs) + 1):
        perm = torch.as_tensor(perms[epoch - 1], device=device)
        t0 = time.perf_counter()
        params, _, history = fit_scan(
            loss_fn, params, optimizer, x_train[perm], generator=generator,
            epochs=1, batch_size=protocols.VAE_BATCH, shuffle=False)
        seconds.append(time.perf_counter() - t0)
        curve.append(-float(history.mean()))
        if callback is not None:
            callback(epoch, curve[-1], seconds[-1])
    return params, curve, seconds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--n_test", default=1000, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    from zhusuan_tpu_torch.examples.utils.dataset import load_binary_mnist

    x_train, _, x_test, synthetic = load_binary_mnist()
    if synthetic:
        print("[note] MNIST files not found; using synthetic MNIST-shaped "
              "data.")
    x_dim, z_dim = 784, 40
    x_train = torch.as_tensor(x_train, device=device)
    x_test = torch.as_tensor(x_test[:hps.n_test], device=device)
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         x_dim, z_dim)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3)
    generator = torch.Generator().manual_seed(1234)
    loss_fn = fit_loss(z_dim)
    t0 = time.perf_counter()

    def on_epoch(epoch, neg_lb):
        nonlocal t0
        print("Epoch {} ({:.1f}s): Lower bound = {:.4f}".format(
            epoch + 1, time.perf_counter() - t0, -neg_lb))
        t0 = time.perf_counter()

    # Stages of at most 5 epochs, each followed by the test log-likelihood.
    done = 0
    while done < hps.epochs:
        stage = min(5, hps.epochs - done)
        params, _, _ = fit_scan(
            loss_fn, params, optimizer, x_train, generator=generator,
            epochs=stage, batch_size=hps.batch_size,
            callback=lambda e, loss, s=done: on_epoch(s + e, loss))
        done += stage
        test_ll = eval_is_loglikelihood(params, x_test, generator, z_dim,
                                        n_particles=1000)
        print(">>> TEST LOG LIKELIHOOD (IS, k=1000) = {:.4f}".format(
            test_ll))
    return params


if __name__ == "__main__":
    main()
