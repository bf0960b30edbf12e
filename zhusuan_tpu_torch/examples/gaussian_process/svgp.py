"""Sparse variational Gaussian process regression (SVGP, Hensman 2013).

Port of ``examples/gaussian_process/svgp.py`` (parity: reference
``examples/gaussian_process/svgp.py``, BASELINE config #5 part 2): 100
inducing points, a ``MultivariateNormalCholesky`` posterior over f(Z), and
p(fx | fz) cancelled between the model and the variational by zeroing its
latent log-prob (reference :123-139). The inducing Gram matrix is factored
once per step by :func:`zhusuan_tpu_torch.ops.cholesky_inverse` (the
hand-written CUDA kernel on the card), shared by the model and the
variational.

Published reference results (svgp.py:12-18): Boston RMSE 2.90 / NLL 2.52,
Protein RMSE 4.49 / NLL 2.93, on the UCI files, which this repository does
not carry: without them the loaders fall back to deterministic synthetic
data of the same shapes and the published numbers do not apply.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.gaussian_process.svgp \\
        [-dataset boston_housing|diabetes|protein_data] [-n_epoch 2000]

The data helpers (the synthetic splits of the measured recipe, the file-or-
synthetic UCI loaders, the scikit-learn diabetes set) live in
:mod:`zhusuan_tpu_torch.examples.utils.dataset` and are re-exported here.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from zhusuan_tpu_torch import variational
from zhusuan_tpu_torch.examples.gaussian_process.utils import (
    RBFKernel,
    gp_conditional,
)
from zhusuan_tpu_torch.examples.utils import nn, protocols
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.dataset import (
    load_uci_boston_housing,
    load_uci_diabetes,
    load_uci_protein_data,
    regression_splits,
    standardize,
    synthetic_regression,
)
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.ops.linalg import cholesky_inverse
from zhusuan_tpu_torch.utils import log_mean_exp

__all__ = [
    "SVGP_CONFIG", "PARAM_NAMES", "synthetic_regression", "standardize",
    "regression_splits", "load_uci_boston_housing", "load_uci_diabetes",
    "load_uci_protein_data",
    "kzz_cholesky", "kzz_factors", "build_model", "build_variational_samples",
    "init_params", "params_from_numpy", "params_to_numpy", "elbo_loss",
    "make_optimizer", "train_step", "predict", "step_keys", "main",
]

# The Boston protocol (baseline_ref/configs_protocol.py:56-57): 100 inducing
# points, 20 particles, full batch (456 <= 5000), Adam(1e-2), 30 warm-up
# then 600 timed steps, synthetic data from seed 42.
SVGP_CONFIG = protocols.SVGP

PARAM_NAMES = ("k_raw_scale", "z_pos", "z_mean", "z_cov_raw", "noise_raw")
_JITTER = 1e-6


# --------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------- #
def _jittered_kzz(params, n_z):
    kernel = RBFKernel(params["k_raw_scale"])
    kzz = kernel(params["z_pos"], params["z_pos"])
    return kzz + _JITTER * torch.eye(n_z, dtype=kzz.dtype, device=kzz.device)


def kzz_cholesky(params, n_z):
    """Cholesky factor of the jittered inducing Gram matrix, computed once
    per step and shared between the model and the variational."""
    return torch.linalg.cholesky(_jittered_kzz(params, n_z))


def kzz_factors(params, n_z):
    """``(L, L^{-1})`` of the jittered inducing Gram matrix by
    :func:`zhusuan_tpu_torch.ops.cholesky_inverse` (the CUDA kernel on the
    card), so that every downstream whitening is a matmul."""
    return cholesky_inverse(_jittered_kzz(params, n_z))


def build_model(params, x, n_z, n_particles, kzz_chol=None,
                kzz_chol_inv=None):
    """p(fz) p(fx | fz) p(y | fx) (reference svgp.py:49-73).

    Pass ``kzz_chol``/``kzz_chol_inv`` (see :func:`kzz_factors`) to share
    one factorization across the model and the variational and score the
    p(fz) prior by a matmul instead of a triangular solve."""
    kernel = RBFKernel(params["k_raw_scale"])
    z_pos = params["z_pos"]

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        if kzz_chol is None:
            Kzz = kernel(z_pos, z_pos)
            Kzz_chol = torch.linalg.cholesky(
                Kzz + _JITTER * torch.eye(n_z, dtype=Kzz.dtype,
                                          device=Kzz.device))
        else:
            Kzz_chol = kzz_chol
        fz = bn.multivariate_normal_cholesky(
            "fz", torch.zeros(n_z, dtype=Kzz_chol.dtype,
                              device=Kzz_chol.device), Kzz_chol,
            n_samples=n_particles, cov_tril_inv=kzz_chol_inv)
        fx = bn.stochastic(
            "fx", gp_conditional(z_pos, fz.tensor, x, False, kernel,
                                 Kzz_chol, Kzz_chol_inv=kzz_chol_inv))
        noise_level = F.softplus(params["noise_raw"])
        bn.normal("y", fx.tensor, std=noise_level, group_ndims=1)
        return bn

    return model()


def build_variational_samples(params, x, n_z, n_particles, key,
                              kzz_chol=None, kzz_chol_inv=None, noise=None):
    """q(fz) q(fx | fz): the latent dict with p(fx | fz)'s log-prob zeroed
    (reference svgp.py:123-139).

    :param key: int seed of the variational net's generators.
    :param noise: optional ``{"fz": eps, "fx": eps}`` standard normals
        replacing the draws (testing hook, see
        :class:`~zhusuan_tpu_torch.framework.bn.BayesianNet`).
    """
    kernel = RBFKernel(params["k_raw_scale"])
    z_pos = params["z_pos"]
    bn = BayesianNet(key=key, noise=noise)
    z_cov_raw = params["z_cov_raw"]
    z_cov_tril = torch.tril(z_cov_raw, -1) + torch.diag(
        F.softplus(torch.diagonal(z_cov_raw)))
    fz = bn.multivariate_normal_cholesky("fz", params["z_mean"], z_cov_tril,
                                         n_samples=n_particles)
    fx_dist = gp_conditional(z_pos, fz.tensor, x, False, kernel, kzz_chol,
                             Kzz_chol_inv=kzz_chol_inv)
    bn.stochastic("fx", fx_dist)
    var_fz, var_fx = bn.query(["fz", "fx"], outputs=True,
                              local_log_prob=True)
    var_fx = (var_fx[0], torch.zeros_like(var_fx[1]))
    return {"fz": var_fz, "fx": var_fx}


def init_params(n_z, n_covariates, x_train, device=None):
    """The JAX example's initial parameters (``svgp.py:129-147``; its key is
    unused there too): inducing positions at distinct training inputs plus
    0.01 jitter from ``RandomState(1234)``, in ``x_train``'s dtype, as leaf
    tensors that require grad, on ``device`` (the card by default)."""
    device = _device(device)
    rng = np.random.RandomState(1234)
    n_train = x_train.shape[0]
    idx = rng.choice(n_train, size=n_z, replace=n_train < n_z)
    dtype = torch.as_tensor(np.asarray(x_train)).dtype
    z_init = x_train[idx] + 0.01 * rng.randn(n_z, n_covariates)
    params = {
        "k_raw_scale": RBFKernel.init_params(n_covariates, dtype, device),
        "z_pos": torch.as_tensor(z_init, dtype=dtype, device=device),
        "z_mean": torch.zeros(n_z, dtype=dtype, device=device),
        "z_cov_raw": torch.eye(n_z, dtype=dtype, device=device),
        "noise_raw": torch.tensor(0.05, dtype=dtype, device=device),
    }
    return {k: v.requires_grad_(True) for k, v in params.items()}


def params_from_numpy(arrays, device=None, dtype=None):
    """Leaf tensors (requiring grad) from a dict of numpy arrays under the
    JAX example's names, e.g. the JAX package's parameters as numpy."""
    return nn.params_from_numpy({k: arrays[k] for k in PARAM_NAMES},
                                device, dtype)


def params_to_numpy(params):
    """The parameters as a dict of numpy arrays (JAX names)."""
    return nn.params_to_numpy({k: params[k] for k in PARAM_NAMES})


def _device(device):
    return torch.device("cuda", 0) if device is None else torch.device(device)


# --------------------------------------------------------------------- #
# Training and prediction
# --------------------------------------------------------------------- #
def elbo_loss(params, x, y, n_z, n_particles, n_train, key,
              chol_inverse=True, noise=None):
    """The example's ``loss_fn`` (svgp.py:172-190): ``(mean(sgvb), mean
    lower bound)`` of a minibatch ``(x, y)``, its likelihood scaled to
    ``n_train`` rows.

    :param chol_inverse: factor the inducing Gram matrix with
        :func:`kzz_factors` (``L`` and ``L^{-1}``, the kernel path); False
        takes :func:`kzz_cholesky` alone, so the conditional and the prior
        go through triangular solves (the plain path).
    :param noise: ``{"fz": eps, "fx": eps}`` for the variational draws
        (testing hook).
    """
    batch_size = x.shape[0]
    if chol_inverse:
        chol, chol_inv = kzz_factors(params, n_z)
    else:
        chol, chol_inv = kzz_cholesky(params, n_z), None
    model = build_model(params, x, n_z, n_particles, kzz_chol=chol,
                        kzz_chol_inv=chol_inv)

    def log_joint(bn):
        prior, log_py_given_fx = bn.cond_log_prob(["fz", "y"])
        return prior + log_py_given_fx / batch_size * n_train

    model.log_joint = log_joint
    latent = build_variational_samples(params, x, n_z, n_particles, key,
                                       kzz_chol=chol, kzz_chol_inv=chol_inv,
                                       noise=noise)
    lower_bound = variational.elbo(model, observed={"y": y}, latent=latent,
                                   axis=0)
    return torch.mean(lower_bound.sgvb()), torch.mean(lower_bound.tensor)


def make_optimizer(params, lr):
    """``torch.optim.Adam`` over the parameters (optax.adam's defaults:
    betas 0.9/0.999, eps 1e-8)."""
    return torch.optim.Adam([params[k] for k in PARAM_NAMES], lr=lr)


def train_step(params, optimizer, x, y, n_z, n_particles, n_train, key,
               chol_inverse=True, noise=None):
    """One Adam step on :func:`elbo_loss`; returns the detached mean lower
    bound (no host sync)."""
    optimizer.zero_grad(set_to_none=True)
    loss, lb = elbo_loss(params, x, y, n_z, n_particles, n_train, key,
                         chol_inverse=chol_inverse, noise=noise)
    loss.backward()
    optimizer.step()
    return lb.detach()


@torch.no_grad()
def predict(params, x, y, n_z, n_particles, std_y_train, keys, noise=None):
    """Posterior-predictive RMSE and test log-likelihood (the example's
    ``predict``, svgp.py:200-219; reference :147-153).

    :param keys: ``(k_q, k_m)`` int seeds of the variational and the model
        nets.
    :param noise: optional ``{"fz": eps, "fx": eps}`` for the variational
        draws (testing hook).
    :return: ``(rmse, ll)`` as 0-d tensors.
    """
    k_q, k_m = keys
    batch_size = x.shape[0]
    latent = build_variational_samples(params, x, n_z, n_particles, k_q,
                                       noise=noise)
    fx_samples = latent["fx"][0]
    model = build_model(params, x, n_z, n_particles)
    # fz stays unobserved in the prediction net (the builder samples it to
    # form the conditional), so a key is required.
    bn = model.observe(k_m, fx=fx_samples, y=y)
    log_likelihood = bn.cond_log_prob("y")
    ll = torch.mean(log_mean_exp(log_likelihood, 0) / batch_size) \
        - float(np.log(std_y_train))
    y_pred = torch.mean(bn["y"].dist.mean, dim=0)
    rmse = torch.sqrt(torch.mean((y_pred - y) ** 2)) * std_y_train
    return rmse, ll


def step_keys(seed, n):
    """``n`` int seeds for successive steps, drawn from ``seed`` on the
    host (the counterpart of splitting a JAX key per step)."""
    return [int(k) for k in np.random.RandomState(seed).randint(
        0, 2 ** 31 - 1, size=n)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-n_z", default=100, type=int)
    parser.add_argument("-n_particles", default=20, type=int)
    parser.add_argument("-n_particles_test", default=100, type=int)
    parser.add_argument("-batch_size", default=5000, type=int)
    parser.add_argument("-n_epoch", default=2000, type=int)
    parser.add_argument("-dataset", default="boston_housing", type=str,
                        choices=["boston_housing", "diabetes",
                                 "protein_data"])
    parser.add_argument("-lr", default=1e-2, type=float)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    device = resolve_device(hps.device)
    loader = {"boston_housing": load_uci_boston_housing,
              "diabetes": load_uci_diabetes,
              "protein_data": load_uci_protein_data}[hps.dataset]
    x_train, y_train, x_valid, y_valid, x_test, y_test, synthetic = loader()
    if synthetic:
        print("[note] UCI data not found; using synthetic regression data "
              "-- published RMSE targets do not apply.")
    x_train = np.vstack([x_train, x_valid])
    y_train = np.hstack([y_train, y_valid])
    n_train, n_covariates = x_train.shape
    x_train, x_test, _, _ = standardize(x_train, x_test)
    y_train, y_test, _, std_y_train = standardize(y_train, y_test)
    x_train, x_test = x_train.astype(np.float32), x_test.astype(np.float32)
    y_train, y_test = y_train.astype(np.float32), y_test.astype(np.float32)
    std_y_train = float(std_y_train)

    params = init_params(hps.n_z, n_covariates, x_train, device=device)
    optimizer = make_optimizer(params, hps.lr)
    xt = torch.as_tensor(x_test, device=device)
    yt = torch.as_tensor(y_test, device=device)
    batch_size = min(hps.batch_size, n_train)
    iters = (n_train - 1) // batch_size + 1
    keys = iter(step_keys(1234, hps.n_epoch * (iters + 2)))
    t0 = time.perf_counter()
    for epoch in range(1, hps.n_epoch + 1):
        perm = np.random.RandomState(epoch).permutation(n_train)
        lbs = []
        for t in range(iters):
            idx = perm[t * batch_size:(t + 1) * batch_size]
            x = torch.as_tensor(x_train[idx], device=device)
            y = torch.as_tensor(y_train[idx], device=device)
            lbs.append(train_step(params, optimizer, x, y, hps.n_z,
                                  hps.n_particles, n_train, next(keys)))
        if epoch % 100 == 0:
            rmse, ll = predict(params, xt, yt, hps.n_z, hps.n_particles_test,
                               std_y_train, (next(keys), next(keys)))
            print("Epoch {}: lower bound = {:.4f}, test rmse = {:.4f}, "
                  "test ll = {:.4f} ({:.1f} s)".format(
                      epoch, float(torch.stack(lbs).mean()), float(rmse),
                      float(ll), time.perf_counter() - t0))
    return params


if __name__ == "__main__":
    main()
