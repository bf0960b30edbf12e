"""General utilities (port of ``zhusuan_tpu/utils.py``).

Capability parity with reference ``zhusuan/utils.py`` (log_sum_exp at
utils.py:156, log_mean_exp at utils.py:177, merge_dicts at utils.py:220),
on torch tensors; the JAX module's small helpers (``split_by_names``,
``add_name_scope``, ``docinherit``, ``if_raise``, ``cached_property``); and
two helpers for nested dict/list/tuple trees of tensors (``jax.tree.map``
and ``jax.tree.leaves`` in the JAX package).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from zhusuan_tpu_torch.profiling import span

__all__ = ["log_sum_exp", "log_mean_exp", "merge_dicts", "split_by_names",
           "add_name_scope", "docinherit", "if_raise", "cached_property",
           "tree_map", "tree_leaves"]


def _dims(x, axis):
    return tuple(range(x.ndim)) if axis is None else axis


def log_sum_exp(x, axis=None, keepdims=False):
    """Numerically stable log-sum-exp along ``axis`` (all axes when None).

    Parity: reference ``zhusuan/utils.py:156-174``.
    """
    x = torch.as_tensor(x)
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdims)


def log_mean_exp(x, axis=None, keepdims=False):
    """Numerically stable log-mean-exp along ``axis`` (all axes when None).

    Parity: reference ``zhusuan/utils.py:177-208``. An all ``-inf`` slice
    is shifted by 0 instead of its (infinite) max, so it gives ``-inf``
    rather than NaN.
    """
    x = torch.as_tensor(x)
    dims = _dims(x, axis)
    x_max = torch.amax(x, dim=dims, keepdim=True).detach()
    x_max = torch.where(torch.isfinite(x_max), x_max, torch.zeros_like(x_max))
    out = torch.log(torch.mean(torch.exp(x - x_max), dim=dims,
                               keepdim=True)) + x_max
    if not keepdims:
        out = out.reshape(()) if axis is None else out.squeeze(dims)
    return out


def merge_dicts(*dict_list: Dict[str, Any]) -> Dict[str, Any]:
    """Merge dicts; later dicts take precedence on key conflicts.

    Parity: reference ``zhusuan/utils.py:220-231``.
    """
    out: Dict[str, Any] = {}
    for d in dict_list:
        if d:
            out.update(d)
    return out


def split_by_names(d: Dict[str, Any], names) -> Dict[str, Any]:
    """Return the sub-dict of ``d`` restricted to ``names`` present in ``d``."""
    return {k: d[k] for k in names if k in d}


def add_name_scope(fn):
    """Decorator labelling ``fn``'s work with its name in profiler traces
    (:func:`~zhusuan_tpu_torch.profiling.span`: free while nothing
    profiles; reference ``zhusuan/utils.py:211-217`` used
    ``tf.name_scope``, the JAX package ``jax.named_scope``).
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper


def docinherit(src):
    """Decorator: copy the docstring from ``src`` if the target has none."""

    def deco(fn):
        if not fn.__doc__:
            fn.__doc__ = src.__doc__
        return fn

    return deco


def if_raise(cond: bool, exception: Exception):
    """Raise ``exception`` if ``cond``. Parity: ``zhusuan/utils.py:234``."""
    if cond:
        raise exception


def cached_property(fn):
    """Per-instance cached property: ``fn(self)`` runs once, its value is
    kept on the instance."""
    attr = "_cached_" + fn.__name__

    @property
    @functools.wraps(fn)
    def wrapper(self):
        if not hasattr(self, attr):
            setattr(self, attr, fn(self))
        return getattr(self, attr)

    return wrapper


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested dict/list/tuple tree (with
    the matching leaves of the trees in ``rest``, of the same structure, as
    further arguments)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict/list/tuple tree, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
