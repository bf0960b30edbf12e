"""A Bayesian linear regression over one latent, ``"w"``: the program's
``GaussianLinearRegressionLogJoint`` on the data the plain side draws
from the configuration's ``data_seed``."""

from __future__ import annotations

from benchmark.reference.targets.linear_regression import data


def density(config, device):
    """The configuration's target as the program's built-in density (its
    data table goes to ``device`` when a kernel first reads it)."""
    from zhusuan_tpu_torch import GaussianLinearRegressionLogJoint

    x, y = data(config)
    return GaussianLinearRegressionLogJoint(
        "w", x, y, config["prior_std"], config["noise_std"])


def latents(q):
    return {"w": q}


def flat(tree):
    return tree["w"]
