"""Bayesian neural network regression with SGHMC and EM on the prior scales.

Port of ``examples/bayesian_neural_nets/bnn_sgmcmc.py`` (parity: reference
``examples/bayesian_neural_nets/bnn_sgmcmc.py``, BASELINE config #4 part
2): SGHMC over the weights (20 particles as parallel chains; second order,
lr 2e-6, friction 0.2, the momentum resampled every 1000 steps), the
minibatch-rescaled log-joint, and an M step that re-estimates the
per-weight prior log-stds from the particles' second moments (reference
:82-100). The latent is a dict of weights, so SGHMC takes its plain path in
both packages.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.bayesian_neural_nets.bnn_sgmcmc
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.bayesian_neural_nets.bnn_vi import forward
from zhusuan_tpu_torch.examples.utils import dataset
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import SGHMC
from zhusuan_tpu_torch.ops._random import philox_key

__all__ = ["build_bnn", "make_model", "make_sampler", "init_weights",
           "init_logstds", "e_step", "m_step", "predict", "main"]


def build_bnn(x, layer_sizes, logstds, n_particles):
    """p(W | logstds) p(y | x, W) (reference bnn_sgmcmc.py:19-36)."""

    @meta_bayesian_net()
    def bnn():
        bn = BayesianNet()
        ws = [bn.normal("w" + str(i),
                        torch.zeros([n_out, n_in + 1], dtype=x.dtype,
                                    device=x.device),
                        logstd=logstds[i], group_ndims=2,
                        n_samples=n_particles).tensor
              for i, (n_in, n_out) in enumerate(zip(layer_sizes[:-1],
                                                    layer_sizes[1:]))]
        bn.deterministic("y_mean", forward(ws, x, n_particles))
        bn.normal("y", bn.get("y_mean"), logstd=-0.95)
        return bn

    return bnn()


def make_model(x, layer_sizes, logstds, n_particles, n_train):
    """:func:`build_bnn` with the log-joint's likelihood rescaled from the
    minibatch to ``n_train`` rows."""
    w_names = ["w" + str(i) for i in range(len(layer_sizes) - 1)]
    model = build_bnn(x, layer_sizes, logstds, n_particles)

    def log_joint(bn):
        log_pws = bn.cond_log_prob(w_names)
        log_py_xw = bn.cond_log_prob("y")
        return sum(log_pws) + torch.mean(log_py_xw, 1) * n_train

    model.log_joint = log_joint
    return model


def make_sampler(lr=2e-6, friction=0.2, n_iter_resample_v=1000):
    """The example's second-order SGHMC."""
    return SGHMC(learning_rate=lr, friction=friction,
                 n_iter_resample_v=n_iter_resample_v, second_order=True)


def init_weights(generator, layer_sizes, n_particles, dtype=torch.float32):
    """Each layer's particles uniform on [-2, 2), ``[n_particles, n_out,
    n_in + 1]``, drawn from ``generator`` (on the device they go to)."""
    return {"w" + str(i): torch.rand((n_particles, n_out, n_in + 1),
                                     generator=generator, dtype=dtype,
                                     device=generator.device) * 4 - 2
            for i, (n_in, n_out) in enumerate(zip(layer_sizes[:-1],
                                                  layer_sizes[1:]))}


def init_logstds(layer_sizes, dtype=torch.float32, device=None):
    """Zero prior log-stds, one ``[n_out, n_in + 1]`` tensor a layer."""
    return [torch.zeros([n_out, n_in + 1], dtype=dtype, device=device)
            for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:])]


def e_step(sampler, state, logstds, x, y, layer_sizes, n_particles, n_train,
           key, noise=None):
    """One SGHMC transition on a minibatch: ``(state, mean_k)``."""
    model = make_model(x, layer_sizes, logstds, n_particles, n_train)
    state, info = sampler.sample(model, {"y": y}, state, key, noise=noise)
    return state, info.mean_k


@torch.no_grad()
def m_step(state, layer_sizes):
    """The prior log-stds re-estimated from the particles' second moments
    (reference :97-100)."""
    return [0.5 * torch.log(torch.mean(state.q["w" + str(i)] ** 2, dim=0))
            for i in range(len(layer_sizes) - 1)]


@torch.no_grad()
def predict(state, logstds, x, layer_sizes, n_particles):
    """The posterior-predictive mean over the particles, ``[n]``."""
    model = build_bnn(x, layer_sizes, logstds, n_particles)
    bn = model.observe(**state.q)
    return torch.mean(bn["y_mean"], 0)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=500, type=int)
    parser.add_argument("--batch_size", default=100, type=int)
    parser.add_argument("--n_particles", default=20, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    x_train, y_train, x_valid, y_valid, x_test, y_test, synthetic = (
        dataset.load_uci_protein_data())
    if synthetic:
        print("[note] UCI protein not found; using synthetic regression "
              "data.")
    x_train = np.vstack([x_train, x_valid])
    y_train = np.hstack([y_train, y_valid])
    n_train, x_dim = x_train.shape
    x_train, x_test, _, _ = dataset.standardize(x_train, x_test)
    y_train, y_test, _, std_y_train = dataset.standardize(y_train, y_test)
    x_train, y_train, x_test, y_test = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (x_train, y_train, x_test, y_test))

    layer_sizes = [x_dim, 50, 1]
    n_particles = hps.n_particles
    generator = torch.Generator().manual_seed(1237)
    w_init = init_weights(
        torch.Generator(device=device).manual_seed(1237), layer_sizes,
        n_particles)
    logstds = init_logstds(layer_sizes, device=device)
    sampler = make_sampler()
    state = sampler.init(w_init, key=philox_key(generator))
    key = philox_key(generator)

    iters = (n_train - 1) // hps.batch_size + 1
    for epoch in range(1, hps.epochs + 1):
        perm = torch.as_tensor(np.random.RandomState(epoch).permutation(
            n_train), device=device)
        for t in range(iters):
            idx = perm[t * hps.batch_size:(t + 1) * hps.batch_size]
            state, _ = e_step(sampler, state, logstds, x_train[idx],
                              y_train[idx], layer_sizes, n_particles,
                              n_train, key)
        logstds = m_step(state, layer_sizes)
        if epoch % 50 == 0:
            y_pred = predict(state, logstds, x_test, layer_sizes,
                             n_particles)
            rmse = float(torch.sqrt(torch.mean((y_pred - y_test) ** 2))
                         * float(std_y_train))
            print("Epoch {}: test rmse = {:.4f}".format(epoch, rmse))
    return state, logstds


if __name__ == "__main__":
    main()
