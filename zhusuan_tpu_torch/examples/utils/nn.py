"""Minimal explicit-parameter neural-net helpers for the port's examples.

Port of ``examples/utils/nn.py:29-79`` (``init_linear``, ``linear_apply``,
``init_mlp``, ``mlp_apply``): parameters are nested dicts and lists of leaf
tensors, a dense layer ``{"w": [in, out], "b": [out]}``. The conv helpers
come with ``vae_conv``. :func:`params_from_numpy` and
:func:`params_to_numpy` carry such trees to and from numpy (the JAX
package's weights cross over that way). Nothing here sets torch's global
matmul flags (TF32 and the like): a float32 product is what the caller's
settings make it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

from zhusuan_tpu_torch.utils import tree_map

__all__ = [
    "init_linear",
    "linear_apply",
    "init_mlp",
    "mlp_apply",
    "params_from_numpy",
    "params_to_numpy",
]


def init_linear(generator, n_in: int, n_out: int, dtype=torch.float32,
                device=None):
    """He-initialized dense layer ``{"w": [in, out], "b": [out]}``: ``w``
    normal with std ``sqrt(2 / n_in)`` drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; None takes the generator's device),
    ``b`` zero; leaf tensors that require grad."""
    device = _device(device, generator)
    w = torch.randn((n_in, n_out), generator=generator, dtype=dtype,
                    device=device) * math.sqrt(2.0 / n_in)
    return {"w": w.requires_grad_(True),
            "b": torch.zeros(n_out, dtype=dtype,
                             device=device).requires_grad_(True)}


def linear_apply(params, x, compute_dtype=None):
    """Dense layer ``x @ w + b``. ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts the input and the weights for the product
    (mixed precision: parameters and optimizer state keep their dtype, and
    the cast's backward brings the gradients back to it)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        return x @ params["w"].to(compute_dtype) \
            + params["b"].to(compute_dtype)
    return x @ params["w"] + params["b"]


def init_mlp(generator, sizes: Sequence[int], dtype=torch.float32,
             device=None) -> List:
    """An MLP with layer widths ``sizes`` (input first), each layer from
    :func:`init_linear` with draws from ``generator`` in turn."""
    return [init_linear(generator, n_in, n_out, dtype, device)
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params: List, x, activation: Callable = torch.relu,
              final_activation=None, compute_dtype=None):
    """Apply an MLP: hidden layers use ``activation``, the last
    ``final_activation`` (None: linear). ``compute_dtype`` runs every
    layer's product and activation in that dtype (see
    :func:`linear_apply`); the output is cast back to the input's dtype so
    the distribution heads downstream keep full precision."""
    out_dtype = x.dtype
    for i, layer in enumerate(params):
        x = linear_apply(layer, x, compute_dtype=compute_dtype)
        if i + 1 < len(params):
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    if compute_dtype is not None:
        x = x.to(out_dtype)
    return x


def params_from_numpy(tree, device=None, dtype=None):
    """A tree of leaf tensors that require grad from a nested dict/list
    tree of arrays (e.g. the JAX package's parameters as numpy), on
    ``device`` (the card when None) in ``dtype`` (the arrays' own when
    None)."""
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)
    return tree_map(lambda a: torch.tensor(
        np.array(a), dtype=dtype, device=device).requires_grad_(True), tree)


def params_to_numpy(tree):
    """The tree with every tensor as a numpy array (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _device(device, generator):
    if device is not None:
        return torch.device(device)
    return generator.device
