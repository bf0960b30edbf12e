"""Packaged training loops: the reference's "loop over epochs, see a loss
history" ergonomics in one call.

Port of ``zhusuan_tpu/fit.py`` (``make_fit_epoch``, ``fit_scan``): the same
signatures and return shapes, on torch. Where the JAX package runs an epoch
as one ``lax.scan`` program, the port runs it as a Python loop over the
step (loss, backward, ``optimizer.step()``). On the card an epoch makes no
host sync: each step's loss is written into a preallocated device vector
that is read once, at the end of the epoch.

Randomness: ``generator`` is a ``torch.Generator`` on the CPU, the
counterpart of the JAX key. Each epoch draws its shuffle
(``torch.randperm``) and one int seed per step from it on the host; each
step's ``loss_fn`` gets a fresh ``torch.Generator`` on the data's device
seeded with that step's seed (``generator.initial_seed()`` recovers it, a
host read, e.g. as a ``BayesianNet`` key).

``opt_state`` has the snapshot semantics of the JAX package's immutable
optax state: a returned ``opt_state`` is a deep copy of the optimizer's
``state_dict()``, and a given one is copied before it is loaded, so neither
aliases the moments that ``optimizer.step()`` updates in place. The copy is
made once a call, never inside the step loop.

The step is not captured in a CUDA graph: a ``BayesianNet`` re-seeds its
per-node generators on the host every step, which a captured graph would
replay with the seeds of the capture.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from zhusuan_tpu_torch.utils import tree_leaves, tree_map

__all__ = ["make_fit_epoch", "fit_scan", "draw_keys"]

_SEED_HIGH = 2 ** 62


def draw_keys(generator: torch.Generator, n: int):
    """``n`` int seeds (e.g. ``BayesianNet`` keys) drawn on the host from a
    CPU ``generator``: the counterpart of splitting a JAX key ``n`` ways."""
    _check_host_generator(generator)
    return torch.randint(0, _SEED_HIGH, (int(n),),
                         generator=generator).tolist()


def _check_host_generator(generator):
    if not isinstance(generator, torch.Generator):
        raise TypeError("generator must be a torch.Generator; got {!r}."
                        .format(type(generator)))
    if generator.device.type != "cpu":
        raise ValueError(
            "generator must live on the CPU (it draws the shuffles and the "
            "steps' seeds on the host); got one on {}.".format(
                generator.device))


def _load(optimizer, opt_state):
    if opt_state is not None:
        optimizer.load_state_dict(copy.deepcopy(opt_state))


def _snapshot(optimizer):
    return copy.deepcopy(optimizer.state_dict())


def _run_epoch(loss_fn, optimizer, params, batches, generator):
    """The steps over ``batches``' leading axis; the per-step losses on
    the data's device."""
    first = tree_leaves(batches)[0]
    n_batches, device = int(first.shape[0]), first.device
    seeds = draw_keys(generator, n_batches)
    losses = torch.empty(n_batches, dtype=torch.float64, device=device)
    for i, seed in enumerate(seeds):
        batch = tree_map(lambda x: x[i], batches)
        step_gen = torch.Generator(device=device).manual_seed(seed)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, step_gen)
        loss.backward()
        optimizer.step()
        losses[i] = loss.detach()
    return losses


def make_fit_epoch(loss_fn: Callable, optimizer) -> Callable:
    """An epoch function from ``loss_fn(params, batch, generator)`` (a
    scalar tensor) and a ``torch.optim.Optimizer`` over the leaf tensors
    of ``params``.

    Returns ``epoch_fn(params, opt_state, batches, generator) -> (params,
    opt_state, losses)``: ``batches`` is a pytree (dicts, lists, tuples)
    whose leaves carry a leading ``[n_batches, batch_size, ...]`` axis,
    ``opt_state`` a snapshot of the optimizer's ``state_dict()`` (loaded
    first when not None; see the module docstring), ``generator`` the host
    generator the steps' seeds come from, and ``losses`` the per-step loss
    vector ``[n_batches]`` on the data's device (detached). The parameters
    are updated in place and returned.

    The JAX package memoizes the jitted epoch on ``(loss_fn, optimizer)``
    to avoid recompiles; an eager loop compiles nothing, so there is no
    memo here.
    """

    def epoch_fn(params, opt_state, batches, generator):
        _load(optimizer, opt_state)
        losses = _run_epoch(loss_fn, optimizer, params, batches, generator)
        return params, _snapshot(optimizer), losses

    return epoch_fn


def _batch(data, n_batches: int, batch_size: int, perm):
    """Shuffle (optional) and reshape to ``[n_batches, batch_size, ...]``;
    the trailing remainder is dropped."""
    n_used = n_batches * batch_size

    def one(x):
        x = x[perm[:n_used]] if perm is not None else x[:n_used]
        return x.reshape((n_batches, batch_size) + tuple(x.shape[1:]))

    return tree_map(one, data)


def fit_scan(
    loss_fn: Callable,
    params: Any,
    optimizer,
    data: Any,
    *,
    generator: torch.Generator,
    epochs: int = 1,
    batch_size: int = 128,
    opt_state: Any = None,
    shuffle: bool = True,
    callback: Optional[Callable[[int, float], None]] = None,
) -> Tuple[Any, Any, np.ndarray]:
    """Train ``params`` for ``epochs`` epochs of minibatch steps (reference
    train-loop ergonomics, ``zhusuan_tpu/fit.py:93-161``).

    :param loss_fn: ``(params, batch, generator) -> scalar tensor``, where
        ``batch`` is a pytree slice of ``data`` with a leading
        ``batch_size`` axis and ``generator`` the step's generator on the
        data's device (see the module docstring).
    :param params: the parameter pytree of leaf tensors (updated in place).
    :param optimizer: a ``torch.optim.Optimizer`` over those leaves.
    :param data: pytree of tensors (or arrays) with a shared leading example
        axis, kept on their device. A trailing remainder smaller than
        ``batch_size`` is dropped each epoch.
    :param generator: a CPU ``torch.Generator``: the shuffles and the
        steps' seeds.
    :param opt_state: optional snapshot of an optimizer ``state_dict()``
        to start from (copied before it is loaded).
    :param shuffle: draw a permutation of the examples each epoch.
    :param callback: optional ``(epoch, mean_loss)`` run after each epoch.
    :return: ``(params, opt_state, history)`` with ``opt_state`` a deep
        copy of the optimizer's ``state_dict()`` after the last step and
        ``history`` the ``[epochs, n_batches]`` per-step losses (host
        numpy, float64).
    """
    _check_host_generator(generator)
    data = tree_map(torch.as_tensor, data)
    n = int(tree_leaves(data)[0].shape[0])
    n_batches = n // int(batch_size)
    if n_batches < 1:
        raise ValueError("batch_size {} exceeds the dataset size {}.".format(
            batch_size, n))
    _load(optimizer, opt_state)
    device = tree_leaves(data)[0].device

    history = []
    for epoch in range(int(epochs)):
        perm = (torch.randperm(n, generator=generator).to(device)
                if shuffle else None)
        batches = _batch(data, n_batches, int(batch_size), perm)
        losses = _run_epoch(loss_fn, optimizer, params, batches,
                            generator).cpu().numpy()
        history.append(losses)
        if callback is not None:
            callback(epoch, float(losses.mean()))
    return params, _snapshot(optimizer), np.stack(history)
