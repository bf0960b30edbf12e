"""The diagonal Gaussian ``configs/<config>.json`` states by ``loc`` and
``std``: its plain density, the scale in which draws are compared, and
its own work a chain."""

from __future__ import annotations

import torch


class DiagonalGaussian:
    """``log p(x) = sum_j -0.5 (x_j - loc_j)^2 / std_j^2`` (no constant)."""

    def __init__(self, loc, std, dtype):
        self.loc = torch.as_tensor(loc).to(dtype)
        self.std = torch.as_tensor(std).to(dtype)
        self.inv_var = 1.0 / (self.std * self.std)

    def log_prob(self, x):
        z = x - self.loc
        return (-0.5 * z * z * self.inv_var).sum(dim=-1)

    def grad(self, x):
        return -(x - self.loc) * self.inv_var


def dim(config) -> int:
    return len(config["std"])


def density(config, device, dtype):
    """The configuration's density in ``dtype``: ``log_prob`` and ``grad``
    over ``[chains, dim]``."""
    return DiagonalGaussian(torch.tensor(config["loc"], device=device),
                            torch.tensor(config["std"], device=device), dtype)


def scale(config):
    """Each coordinate's standard deviation (float32, on the host), the
    unit in which the checks measure draws."""
    return torch.tensor(config["std"])


def cost(config):
    """The density's necessary work a chain, whatever evaluates it: per
    element 5 operations a log-density (the difference, its square, the
    half, the inverse variance, the sum) and 3 a gradient (the difference,
    the inverse variance, the sign); its parameters are ``loc`` and the
    inverse variance in float32."""
    d = dim(config)
    return {"log_prob_ops": 5 * d, "grad_ops": 3 * d, "param_bytes": 4 * 2 * d}
