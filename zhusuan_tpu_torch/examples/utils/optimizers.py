"""Optimizers for the port's examples.

Port of ``examples/utils/optimizers.py`` (reference
``examples/utils/optimizers.py:11-61``, a custom ``AdamaxOptimizer``; the
JAX package re-exports ``optax.adamax``). ``optax.adamax`` and
``torch.optim.Adamax`` compute the same rule,

    m = b1 m + (1 - b1) g;  u = max(b2 u, |g| + eps);
    p -= lr (m / (1 - b1^t)) / u,

so :func:`adamax` is ``torch.optim.Adamax`` under optax's signature.

``optax.rmsprop(lr)`` (decay 0.9, ``eps_in_sqrt=True``) scales by ``1 /
sqrt(nu + eps)``; ``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps``
(and decays by 0.99), so :class:`RMSProp` is the port's copy of optax's:

    nu = decay nu + (1 - decay) g^2;  p -= lr g / sqrt(nu + eps).
"""

from __future__ import annotations

import torch

__all__ = ["adamax", "AdamaxOptimizer", "RMSProp"]


def adamax(params, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """``optax.adamax``'s signature over ``params``."""
    return torch.optim.Adamax(params, lr=learning_rate, betas=(b1, b2),
                              eps=eps)


def AdamaxOptimizer(params, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                    epsilon=1e-8):
    """The reference constructor's signature over ``params``."""
    return adamax(params, learning_rate, beta1, beta2, epsilon)


class RMSProp(torch.optim.Optimizer):
    """``optax.rmsprop(learning_rate, decay, eps)`` (its defaults:
    ``initial_scale=0``, ``eps_in_sqrt=True``, no momentum, not centred) as
    a torch optimizer.

    :param params: the tensors (or parameter groups) to optimize.
    :param lr: the learning rate.
    :param decay: the squares' decay.
    :param eps: added to the squares' average inside the square root.
    """

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        if not lr > 0.0:
            raise ValueError("lr must be positive; got {}.".format(lr))
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"].mul_(decay).add_(g * g, alpha=1.0 - decay)
                p.sub_(group["lr"] * (g / torch.sqrt(nu + group["eps"])))
        return loss

