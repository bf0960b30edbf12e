"""Bayesian logistic regression by SVGD (Liu & Wang 2016, Sec. 5).

Port of ``examples/stein_variational/blr_svgd.py``: the SVGD paper's
benchmark, a logistic-regression posterior over UCI German credits (the
deterministic synthetic logistic set of the same shape where the file is
absent), inferred by moving a particle ensemble along the Stein direction
(:class:`~zhusuan_tpu_torch.variational.SVGD`, the optax-exact adagrad,
the median bandwidth). The test accuracy averages the per-particle
predictions.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.stein_variational.blr_svgd
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from zhusuan_tpu_torch.examples.utils import dataset
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.variational import SVGD

__all__ = ["make_log_joint", "predict_proba", "load_data", "run", "main"]


def make_log_joint(x, y, prior_std=1.0):
    """``log p(w) + log p(y | x, w)`` over ``[n_particles, d]`` weight
    particles; ``x`` and ``y`` are tensors on the particles' device."""

    def log_joint(obs):
        w = obs["w"]  # [p, d]
        logits = torch.einsum("nd,pd->pn", x.to(w.dtype), w)
        log_lik = torch.sum(y * F.logsigmoid(logits)
                            + (1.0 - y) * F.logsigmoid(-logits), dim=-1)
        log_prior = torch.sum(-0.5 * (w / prior_std) ** 2, dim=-1)
        return log_prior + log_lik

    return log_joint


def predict_proba(w_particles, x):
    """Posterior-predictive ``p(y = 1 | x)``: the mean of the particles'
    sigmoids."""
    logits = torch.einsum("nd,pd->pn", x.to(w_particles.dtype), w_particles)
    return torch.mean(torch.sigmoid(logits), dim=0)


def load_data():
    """German credits standardized by the training statistics, a bias
    column appended: ``(x_train, y_train, x_test, y_test, synthetic)``,
    float32 numpy."""
    x_train, y_train, x_test, y_test, synthetic = (
        dataset.load_uci_german_credits())
    x_train, x_test, _, _ = dataset.standardize(
        x_train.astype(np.float32), x_test.astype(np.float32))
    # The bias column (the reference BLR examples fold the intercept in w).
    x_train = np.concatenate(
        [x_train, np.ones((x_train.shape[0], 1), np.float32)], axis=1)
    x_test = np.concatenate(
        [x_test, np.ones((x_test.shape[0], 1), np.float32)], axis=1)
    return x_train, y_train, x_test, y_test, synthetic


def run(device, n_particles=100, n_iters=2000, learning_rate=0.05,
        dtype=torch.float32, seed=0, w0=None, verbose=True):
    """``(acc, base, state, diagnostics)``: the ensemble's test accuracy,
    the majority class's share, SVGD's final state and its per-iteration
    bandwidth and ``grad_norm``. ``w0``: the initial particles (default
    ``0.1 N(0, 1)`` from ``seed``)."""
    device = torch.device(device)
    x_train, y_train, x_test, y_test, synthetic = load_data()
    d = x_train.shape[1]
    log_joint = make_log_joint(
        torch.as_tensor(x_train, device=device),
        torch.as_tensor(y_train, dtype=dtype, device=device))
    svgd = SVGD(learning_rate=learning_rate)
    if w0 is None:
        w0 = 0.1 * torch.randn(
            (n_particles, d), dtype=dtype, device=device,
            generator=torch.Generator(device=device).manual_seed(seed))
    w0 = torch.as_tensor(w0, dtype=dtype, device=device)
    state, diag = svgd.run(log_joint, {}, svgd.init({"w": w0}), n_iters,
                           collect=True)
    p_test = predict_proba(state.particles["w"],
                           torch.as_tensor(x_test, device=device))
    acc = float(torch.mean(
        ((p_test > 0.5) == (torch.as_tensor(y_test, device=device) > 0.5))
        .double()))
    base = float(max(np.mean(y_test), 1.0 - np.mean(y_test)))
    if verbose:
        print("SVGD BLR{}: test acc {:.3f} (majority-class baseline {:.3f}),"
              " final grad_norm {:.2e}".format(
                  " [synthetic]" if synthetic else "", acc, base,
                  float(diag["grad_norm"][-1])))
    return acc, base, state, diag


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_particles", default=100, type=int)
    parser.add_argument("--n_iters", default=2000, type=int)
    parser.add_argument("--learning_rate", default=0.05, type=float)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    acc, base, _, _ = run(resolve_device(hps.device), hps.n_particles,
                          hps.n_iters, hps.learning_rate)
    return acc, base


if __name__ == "__main__":
    main()
