"""A Bayesian linear regression, ``w ~ N(0, prior_std^2 I)``,
``y_i ~ N(x_i^T w, noise_std^2)``, over ``w [dim]``, on ``rows`` rows
drawn from the configuration's ``data_seed``: its data, its plain
density, the posterior's scale and its own work a chain."""

from __future__ import annotations

import math

import torch


def data(config):
    """``(x [rows, dim], y [rows])``, float64 on the host: standard normal
    predictors, a standard normal ``w``, and ``y = x w`` plus noise."""
    g = torch.Generator().manual_seed(config["data_seed"])
    n, d = config["rows"], config["dim"]
    x = torch.randn((n, d), generator=g, dtype=torch.float64)
    w = torch.randn(d, generator=g, dtype=torch.float64)
    noise = torch.randn(n, generator=g, dtype=torch.float64)
    return x, x @ w + config["noise_std"] * noise


class Regression:
    """The log joint, normalising constants included, and its gradient
    over ``w [chains, dim]``, in ``dtype``."""

    def __init__(self, x, y, prior_std: float, noise_std: float, dtype):
        n, d = x.shape
        self.x, self.y = x.to(dtype), y.to(dtype)
        self.inv_noise, self.inv_prior = 1.0 / noise_std, 1.0 / prior_std
        self.const = (-0.5 * (n + d) * math.log(2.0 * math.pi)
                      - d * math.log(prior_std) - n * math.log(noise_std))

    def _residual(self, w):
        return (self.y - w @ self.x.T) * self.inv_noise

    def log_prob(self, w):
        z, ws = self._residual(w), w * self.inv_prior
        return (-0.5 * (z * z).sum(dim=-1) - 0.5 * (ws * ws).sum(dim=-1)
                + self.const)

    def grad(self, w):
        return ((self._residual(w) * self.inv_noise) @ self.x
                - w * (self.inv_prior * self.inv_prior))


def dim(config) -> int:
    return config["dim"]


def density(config, device, dtype):
    x, y = data(config)
    return Regression(x.to(device), y.to(device), config["prior_std"],
                      config["noise_std"], dtype)


def scale(config):
    """The posterior's standard deviations, ``sqrt(diag((x^T x /
    noise_std^2 + I / prior_std^2)^-1))``, float64 on the host."""
    x, _ = data(config)
    precision = (x.T @ x / config["noise_std"] ** 2
                 + torch.eye(x.shape[1], dtype=x.dtype)
                 / config["prior_std"] ** 2)
    return torch.linalg.inv(precision).diagonal().sqrt()


def cost(config):
    """The density's necessary work a chain: a log-density takes ``x w``
    (``2 n d``), the residual, its scale, square, half and sum (``5 n``)
    and the prior's (``4 d``); a gradient takes ``x w`` and ``x^T r``
    (``4 n d``), the residual and its two scales (``3 n``) and the prior's
    term and the sum (``3 d``); the parameters are the float32 table
    ``[n, d + 1]`` of ``x`` and ``y`` and four constants."""
    n, d = config["rows"], dim(config)
    return {"log_prob_ops": 2 * n * d + 5 * n + 4 * d,
            "grad_ops": 4 * n * d + 3 * n + 3 * d,
            "param_bytes": 4 * (n * (d + 1) + 4)}
