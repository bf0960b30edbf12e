"""Variational dropout: a Bayesian MLP classifier with multiplicative
noise.

Port of ``examples/bayesian_neural_nets/variational_dropout.py`` (parity:
reference ``examples/bayesian_neural_nets/variational_dropout.py``): on
each layer's inputs a noise ``eps ~ N(1, alpha)`` with ``alpha =
sigmoid(logit_alpha)`` learned per input unit, a 784-100-100-100-10 relu
net, a ``Categorical`` head, the log-joint overridden to scale the
likelihood by the training set's size (reference :89-101),
``elbo(...).sgvb()`` with Adam(1e-3, eps=1e-4) at batch 1000 with 10
particles; the test accuracy from 100 particles.

Keys: ``build_q`` and ``loss_fn`` take ``key``, an int seed of the
variational net's generators; ``noise={"layer0/eps": eps, ...}`` replaces
its standard normals (a testing hook).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.bayesian_neural_nets.variational_dropout
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils import dataset
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import init_linear, linear_apply
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.utils import tree_leaves
from zhusuan_tpu_torch.variational import elbo

__all__ = ["NET_HIDDEN", "eps_names", "var_dropout", "build_q",
           "init_params", "loss_fn", "accuracy", "load_data",
           "make_train_step", "main"]

NET_HIDDEN = (100, 100, 100)


def eps_names(net_size):
    return ["layer{}/eps".format(i) for i in range(len(net_size) - 1)]


def var_dropout(params, x, n, net_size, n_particles):
    """The model: noise ``eps`` on each layer's inputs, a Categorical head
    on the last layer's logits (reference variational_dropout.py:18-37)."""
    w = params["layers"][0]["w"]

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        h = x[None].expand((n_particles,) + tuple(x.shape))
        for i, (n_in, _) in enumerate(zip(net_size[:-1], net_size[1:])):
            eps = bn.normal(
                "layer{}/eps".format(i),
                torch.ones([n, n_in], dtype=w.dtype, device=w.device),
                std=1.0, n_samples=n_particles, group_ndims=1)
            h = linear_apply(params["layers"][i], h * eps.tensor)
            if i < len(net_size) - 2:
                h = torch.relu(h)
        bn.categorical("y", h)
        bn.deterministic("y_logit", h)
        return bn

    return model()


def build_q(params, n, net_size, n_particles, key, noise=None):
    """q: ``eps ~ N(1, sqrt(sigmoid(logit_alpha)))`` per input unit
    (reference :40-51)."""
    bn = BayesianNet(key=key, noise=noise)
    for i in range(len(net_size) - 1):
        std = torch.sqrt(torch.sigmoid(params["logit_alphas"][i]) + 1e-10)
        bn.normal("layer{}/eps".format(i), 1.0,
                  std=std[None].expand(n, std.shape[0]),
                  n_samples=n_particles, group_ndims=1)
    return bn


def init_params(generator, net_size, dtype=torch.float32):
    """He-normal layers drawn from ``generator`` in turn; every
    ``logit_alpha`` at -3."""
    layers, logit_alphas = [], []
    for n_in, n_out in zip(net_size[:-1], net_size[1:]):
        layers.append(init_linear(generator, n_in, n_out, dtype))
        logit_alphas.append(torch.full(
            (n_in,), -3.0, dtype=dtype,
            device=generator.device).requires_grad_(True))
    return {"layers": layers, "logit_alphas": logit_alphas}


def accuracy(y_logit, y):
    """The accuracy of the particles' mean predictive probabilities."""
    h_pred = torch.mean(torch.softmax(y_logit, -1), 0)
    return torch.mean((torch.argmax(h_pred, -1) == y).to(y_logit.dtype))


def loss_fn(params, x, y, key, net_size, n_train, n_particles, noise=None):
    """``(cost, accuracy)``: the SGVB surrogate of the bound with the
    likelihood scaled by ``n_train``, over ``n_train``; the accuracy
    detached."""
    n = x.shape[0]
    y_obs = y[None].expand(n_particles, n)
    model = var_dropout(params, x, n, net_size, n_particles)
    names = eps_names(net_size)

    def log_joint(bn):
        log_pe = bn.cond_log_prob(names)
        log_py_xe = bn.cond_log_prob("y")
        return sum(log_pe) + log_py_xe * n_train

    model.log_joint = log_joint
    variational = build_q(params, n, net_size, n_particles, key, noise=noise)
    lower_bound = elbo(model, {"y": y_obs}, variational=variational, axis=0)
    acc = accuracy(lower_bound.bn["y_logit"].detach(), y)
    cost = torch.mean(lower_bound.sgvb()) / n_train
    return cost, acc


def make_train_step(optimizer, net_size, n_train, n_particles=10):
    """One step: ``train_step(params, x, y, key, noise=None) -> (cost,
    accuracy)``, both detached (no host sync)."""

    def train_step(params, x, y, key, noise=None):
        optimizer.zero_grad(set_to_none=True)
        cost, acc = loss_fn(params, x, y, key, net_size, n_train,
                            n_particles, noise=noise)
        cost.backward()
        optimizer.step()
        return cost.detach(), acc

    return train_step


def load_data():
    """The example's data (reference :117-124): MNIST with real-valued
    pixels (the loaders' synthetic digits when the files are absent), the
    validation rows joined to the training rows, both standardized by the
    training statistics. Returns ``(x_train, y_train, x_test, y_test,
    synthetic)``."""
    x_train, y_train, x_valid, y_valid, x_test, y_test, synthetic = (
        dataset.load_mnist_realval())
    x_train = np.vstack([x_train, x_valid]).astype(np.float32)
    y_train = np.concatenate([y_train, y_valid]).astype(np.int32)
    x_train, x_test, _, _ = dataset.standardize(x_train, x_test)
    return (x_train.astype(np.float32), y_train,
            x_test.astype(np.float32), y_test.astype(np.int32), synthetic)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=30, type=int)
    parser.add_argument("--batch_size", default=1000, type=int)
    parser.add_argument("--lb_samples", default=10, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)

    x_train, y_train, x_test, y_test, synthetic = load_data()
    if synthetic:
        print("[note] using synthetic MNIST-shaped data.")
    n_train = x_train.shape[0]
    net_size = [x_train.shape[1], *NET_HIDDEN, 10]
    x_train_d = torch.as_tensor(x_train, device=device)
    y_train_d = torch.as_tensor(y_train, device=device)
    x_test_d = torch.as_tensor(x_test[:2000], device=device)
    y_test_d = torch.as_tensor(y_test[:2000], device=device)
    params = init_params(torch.Generator(device=device).manual_seed(1234),
                         net_size)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=1e-3, eps=1e-4)
    train_step = make_train_step(optimizer, net_size, n_train,
                                 hps.lb_samples)
    generator = torch.Generator().manual_seed(1234)
    for epoch in range(1, hps.epochs + 1):
        batches = torch.as_tensor(
            dataset.epoch_batches(n_train, hps.batch_size, epoch),
            device=device)
        accs = torch.empty(len(batches), device=device)
        for t, (idx, key) in enumerate(zip(
                batches, draw_keys(generator, len(batches)))):
            _, accs[t] = train_step(params, x_train_d[idx], y_train_d[idx],
                                    key)
        if epoch % 3 == 0:
            with torch.no_grad():
                _, test_acc = loss_fn(params, x_test_d, y_test_d,
                                      draw_keys(generator, 1)[0], net_size,
                                      n_train, 100)
            print("Epoch {}: train acc = {:.4f}, test acc = {:.4f}".format(
                epoch, float(accs.mean()), float(test_acc)))
    return params


if __name__ == "__main__":
    main()
