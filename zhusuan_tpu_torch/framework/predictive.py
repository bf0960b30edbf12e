"""Posterior-predictive sampling over a dict of posterior draws.

Port of ``zhusuan_tpu/framework/predictive.py`` (beyond the reference,
whose examples hand-roll the loop): observe the generative net at each
posterior draw, sample its remaining nodes, stack. Where the JAX package
maps one ``vmap`` over the draws with a key each, the port loops over the
draws: draw ``i`` observes the net under the int key
:func:`draw_key` ``(key, i)``, from which each node seeds its own generator
as usual (``framework/bn.py::node_seed``). Where the JAX package finds the
default outputs with a ``jax.eval_shape`` probe, the port reads the node
names off the first draw's net, the first step of the loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from zhusuan_tpu_torch.framework.bn import (
    StochasticTensor,
    _MASK64,
    _splitmix64,
)
from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet

__all__ = ["posterior_predictive", "draw_key"]


def draw_key(key: int, i: int) -> int:
    """The net key of posterior draw ``i`` under ``key``: the key and the
    draw's index through two rounds of the splitmix64 finalizer, as
    ``node_seed`` mixes a key with a node's name."""
    return _splitmix64(_splitmix64(int(key) & _MASK64) ^ int(i))


def posterior_predictive(
    meta_bn: MetaBayesianNet,
    draws: Dict,
    key: int,
    outputs: Optional[List[str]] = None,
):
    """Sample the model's remaining stochastic nodes at each posterior draw.

    :param meta_bn: the generative model.
    :param draws: dict ``{latent_name: [n_draws, ...]}`` of posterior
        draws; every tensor shares the leading draws axis.
    :param key: int seed; draw ``i`` observes the net under
        ``draw_key(key, i)``.
    :param outputs: node names to return (stochastic or deterministic).
        Default: every stochastic node that ``draws`` does not fix (the
        data nodes).
    :return: dict ``{name: [n_draws, ...]}`` of predictive samples.
    """
    if not isinstance(meta_bn, MetaBayesianNet):
        raise TypeError(
            "meta_bn must be a MetaBayesianNet, got {!r}.".format(
                type(meta_bn)))
    if not draws:
        raise ValueError("draws must contain at least one latent.")
    draws = {k: torch.as_tensor(v) for k, v in draws.items()}
    n_set = {v.shape[0] if v.ndim else None for v in draws.values()}
    if None in n_set or len(n_set) != 1:
        raise ValueError(
            "All draws arrays must share a leading n_draws axis; got "
            "shapes {}.".format({k: tuple(v.shape)
                                 for k, v in draws.items()}))
    n_draws = n_set.pop()

    rows = []
    for i in range(n_draws):
        bn = meta_bn.observe(key=draw_key(key, i),
                             **{k: v[i] for k, v in draws.items()})
        if outputs is None:
            outputs = [name for name, node in bn.nodes.items()
                       if isinstance(node, StochasticTensor)
                       and name not in draws]
            if not outputs:
                raise ValueError(
                    "No stochastic nodes remain once draws are observed; "
                    "pass outputs= explicitly.")
        rows.append([bn._node_value(bn.nodes[name]) for name in outputs])
    return {name: torch.stack([row[j] for row in rows])
            for j, name in enumerate(outputs)}
