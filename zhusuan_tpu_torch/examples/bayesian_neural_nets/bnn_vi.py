"""Bayesian neural network regression with mean-field SGVB.

Port of ``examples/bayesian_neural_nets/bnn_vi.py`` (parity: reference
``examples/bayesian_neural_nets/bnn_vi.py``, BASELINE config #4 part 1):
weight-space Normal priors with ``group_ndims=2``, a mean-field Normal
posterior, the custom minibatch-rescaled ``log_joint`` (reference :83-88),
layers [13, 50, 1], batch 10, 10 particles, Adam 0.01, and the
posterior-predictive RMSE and test log-likelihood.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.bayesian_neural_nets.bnn_vi
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from zhusuan_tpu_torch import variational
from zhusuan_tpu_torch.examples.utils import dataset
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.utils import log_mean_exp, tree_leaves

__all__ = ["build_bnn", "build_variational", "init_params", "make_loss",
           "make_train_step", "predict", "forward", "main"]


def forward(ws, x, n_particles):
    """The network's output ``[n_particles, n]`` for weight samples ``ws``
    (``[n_particles, n_out, n_in + 1]`` each, the bias last): relu hidden
    layers, each pre-activation scaled by ``1/sqrt(n_in + 1)``."""
    h = x[None].expand((n_particles,) + tuple(x.shape))
    for i, w in enumerate(ws):
        h = torch.cat([h, torch.ones(h.shape[:-1] + (1,), dtype=h.dtype,
                                     device=h.device)], dim=-1)
        h = torch.einsum("imk,ijk->ijm", w, h) / math.sqrt(h.shape[-1])
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h.squeeze(-1)


def build_bnn(x, layer_sizes, n_particles, y_logstd):
    """The model p(W) p(y | x, W) (reference bnn_vi.py:18-36)."""

    @meta_bayesian_net()
    def bnn():
        bn = BayesianNet()
        ws = [bn.normal("w" + str(i),
                        torch.zeros([n_out, n_in + 1], dtype=x.dtype,
                                    device=x.device),
                        std=1.0, group_ndims=2, n_samples=n_particles).tensor
              for i, (n_in, n_out) in enumerate(zip(layer_sizes[:-1],
                                                    layer_sizes[1:]))]
        y_mean = bn.deterministic("y_mean", forward(ws, x, n_particles))
        bn.normal("y", y_mean, logstd=y_logstd)
        return bn

    return bnn()


def build_variational(params, layer_sizes, n_particles, key, noise=None):
    """The mean-field Normal posterior over the weights (reference
    :38-50); ``noise={"w0": eps, ...}`` replaces its draws."""
    bn = BayesianNet(key=key, noise=noise)
    for i in range(len(layer_sizes) - 1):
        bn.normal("w" + str(i), params["w_means"][i],
                  logstd=params["w_logstds"][i], n_samples=n_particles,
                  group_ndims=2)
    return bn


def init_params(layer_sizes, dtype=torch.float32, device=None):
    """Zero means and log-stds for every layer and a zero ``y_logstd``
    (leaf tensors that require grad; the card when ``device`` is None)."""
    device = torch.device("cuda", 0) if device is None else device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device,
                           requires_grad=True)

    shapes = [(n_out, n_in + 1)
              for n_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:])]
    return {"w_means": [zeros(*s) for s in shapes],
            "w_logstds": [zeros(*s) for s in shapes],
            "y_logstd": zeros()}


def make_loss(layer_sizes, n_train, n_particles):
    """``loss_fn(params, x, y, key, noise=None)``: the mean SGVB cost of a
    minibatch under the log-joint with the likelihood rescaled to
    ``n_train`` rows."""
    w_names = ["w" + str(i) for i in range(len(layer_sizes) - 1)]

    def loss_fn(params, x, y, key, noise=None):
        model = build_bnn(x, layer_sizes, n_particles, params["y_logstd"])

        def log_joint(bn):
            log_pws = bn.cond_log_prob(w_names)
            log_py_xw = bn.cond_log_prob("y")
            return sum(log_pws) + torch.mean(log_py_xw, 1) * n_train

        model.log_joint = log_joint
        guide = build_variational(params, layer_sizes, n_particles, key,
                                  noise=noise)
        lower_bound = variational.elbo(model, {"y": y}, variational=guide,
                                       axis=0)
        return torch.mean(lower_bound.sgvb())

    return loss_fn


def make_train_step(loss_fn, optimizer):
    """One Adam step on ``loss_fn`` (from :func:`make_loss`):
    ``train_step(params, x, y, key, noise=None) -> lower bound`` (detached,
    no host sync)."""

    def train_step(params, x, y, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, x, y, key, noise=noise)
        loss.backward()
        optimizer.step()
        return -loss.detach()

    return train_step


@torch.no_grad()
def predict(params, x, y, layer_sizes, n_particles, key, std_y_train,
            noise=None):
    """Posterior-predictive ``(rmse, log_likelihood)`` as 0-d tensors
    (reference :98-106)."""
    model = build_bnn(x, layer_sizes, n_particles, params["y_logstd"])
    guide = build_variational(params, layer_sizes, n_particles, key,
                              noise=noise)
    bn = variational.elbo(model, {"y": y}, variational=guide, axis=0).bn
    y_pred = torch.mean(bn["y_mean"], 0)
    rmse = torch.sqrt(torch.mean((y_pred - y) ** 2)) * std_y_train
    log_py_xw = bn.cond_log_prob("y")
    ll = torch.mean(log_mean_exp(log_py_xw, 0)) - math.log(std_y_train)
    return rmse, ll


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=500, type=int)
    parser.add_argument("--batch_size", default=10, type=int)
    parser.add_argument("--lb_samples", default=10, type=int)
    parser.add_argument("--ll_samples", default=5000, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    x_train, y_train, x_valid, y_valid, x_test, y_test, synthetic = (
        dataset.load_uci_boston_housing())
    if synthetic:
        print("[note] UCI housing not found; using synthetic regression "
              "data.")
    x_train = np.vstack([x_train, x_valid])
    y_train = np.hstack([y_train, y_valid])
    n_train, x_dim = x_train.shape
    x_train, x_test, _, _ = dataset.standardize(x_train, x_test)
    y_train, y_test, _, std_y_train = dataset.standardize(y_train, y_test)
    x_train, y_train, x_test, y_test = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (x_train, y_train, x_test, y_test))
    std_y_train = float(std_y_train)

    layer_sizes = [x_dim, 50, 1]
    params = init_params(layer_sizes, device=device)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=0.01)
    train_step = make_train_step(
        make_loss(layer_sizes, n_train, hps.lb_samples), optimizer)
    generator = torch.Generator().manual_seed(1237)
    iters = (n_train - 1) // hps.batch_size + 1
    for epoch in range(1, hps.epochs + 1):
        perm = torch.as_tensor(np.random.RandomState(epoch).permutation(
            n_train), device=device)
        lbs = torch.empty(iters, device=device)
        for t, key in enumerate(draw_keys(generator, iters)):
            idx = perm[t * hps.batch_size:(t + 1) * hps.batch_size]
            lbs[t] = train_step(params, x_train[idx], y_train[idx], key)
        if epoch % 50 == 0:
            (key,) = draw_keys(generator, 1)
            rmse, ll = predict(params, x_test, y_test, layer_sizes,
                               hps.ll_samples, key, std_y_train)
            print("Epoch {}: Lower bound = {:.4f}, test rmse = {:.4f}, "
                  "test ll = {:.4f}".format(epoch, float(lbs.mean()),
                                            float(rmse), float(ll)))
    return params


if __name__ == "__main__":
    main()
