"""The diagonal Gaussian ``configs/<config>.json`` states by ``loc`` and
``std``, as the program's built-in density over one latent, ``"x"``."""

from __future__ import annotations

import torch


def density(config, device):
    """The configuration's target as the program's built-in density."""
    from zhusuan_tpu_torch import DiagonalGaussianLogJoint

    return DiagonalGaussianLogJoint(
        "x", torch.tensor(config["loc"], dtype=torch.float32, device=device),
        torch.tensor(config["std"], dtype=torch.float32, device=device))


def latents(q):
    """The latent dict a sampler is given for flat ``[chains, dim]``
    points."""
    return {"x": q}


def flat(tree):
    """A latent dict (draws, positions, mass) back to ``[..., dim]``."""
    return tree["x"]
