"""Checkpoint and resume of sampler state and parameters (port of
``zhusuan_tpu/checkpoint.py``).

The port writes the JAX package's data-only ``npz`` format, so one file
moves between the two packages: a run checkpointed under JAX resumes on the
card, and back. The format holds the leaves as arrays (``leaf_i``), a JSON
list of their key paths (``__paths__``), the step (``__step__``) and the
dtypes numpy cannot name (``__exotic__``: raw bytes plus ``[dtype name,
shape]``). It is read with ``allow_pickle=False``, so restoring an untrusted
file cannot execute code; that is why the port keeps it and not
``torch.save``, whose format is a pickle.

Leaves come in the JAX package's order: dict keys sorted, NamedTuple fields
in declaration order, list and tuple items in order; ``None`` is structure,
not a leaf. A path entry is ``["d", key]`` (a dict key), ``["s", idx]`` (a
sequence index), ``["a", name]`` (a NamedTuple field) or ``["i", repr]`` (a
dict key that is not a string).

Two leaves differ in kind between the packages and are written as JAX
writes them:

- a bfloat16 tensor (numpy has no bfloat16, and the port does not use
  ``ml_dtypes``) is saved as its raw bytes under the dtype name
  ``"bfloat16"`` and restored by viewing ``int16`` as ``torch.bfloat16``;
  ``float8_e4m3fn`` / ``float8_e5m2`` likewise, through ``uint8``;
- a host int in a NamedTuple field (every sampler state's counter ``t``,
  an int32 array in the JAX package) is saved as an int32 scalar, and a
  ``like=`` template that holds an int there gets an int back.

The JAX package writes with orbax when it is installed; the port writes
and reads the npz format only (the GPU host has no orbax).
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint"]

# dtype name in __exotic__ -> (torch dtype, numpy dtype of the same width
# through which its bytes are viewed).
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.int16),
    "float8_e4m3fn": (getattr(torch, "float8_e4m3fn", None), np.uint8),
    "float8_e5m2": (getattr(torch, "float8_e5m2", None), np.uint8),
}
_EXOTIC_NAME = {v[0]: k for k, v in _EXOTIC.items() if v[0] is not None}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node):
    """``[(path entry, child)]`` of a container node in the JAX package's
    leaf order, or None for a leaf."""
    if isinstance(node, dict):
        keys = (list(node) if isinstance(node, collections.OrderedDict)
                else sorted(node))
        return [(["d", k] if isinstance(k, str) else ["i", repr(k)],
                 node[k]) for k in keys]
    if _is_namedtuple(node):
        return [(["a", f], getattr(node, f)) for f in type(node)._fields]
    if isinstance(node, (list, tuple)):
        return [(["s", i], v) for i, v in enumerate(node)]
    return None


def _flatten(tree, path=(), in_fields=False):
    """``[(path, leaf, in_namedtuple_field)]`` in the JAX package's leaf
    order; ``None`` holds no leaf."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(list(path), tree, in_fields)]
    out = []
    for entry, child in children:
        out.extend(_flatten(child, path + (entry,),
                            entry[0] == "a"))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves`` (each already converted for its template leaf)."""
    if like is None:
        return None
    children = _children(like)
    if children is None:
        return next(leaves)
    if isinstance(like, dict):
        values = {k: _unflatten(like[k], leaves) for k in
                  (list(like) if isinstance(like, collections.OrderedDict)
                   else sorted(like))}
        return type(like)((k, values[k]) for k in like)
    values = [_unflatten(child, leaves) for _, child in children]
    if _is_namedtuple(like):
        return type(like)(*values)
    if isinstance(like, tuple):
        return tuple.__new__(type(like), values)
    return type(like)(values)


def _to_numpy(leaf, in_fields):
    """``(array to store, exotic [dtype name, shape] or None)``."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        name = _EXOTIC_NAME.get(x.dtype)
        if name is not None:
            raw = x.contiguous().reshape(-1).view(torch.uint8).numpy()
            return raw.reshape(-1), [name, list(x.shape)]
        return x.numpy(), None
    if isinstance(leaf, bool) or not isinstance(leaf, int) or not in_fields:
        return np.asarray(leaf), None
    return np.asarray(leaf, np.int32), None


def save_checkpoint(path: str, state: Any, step: int = 0, use_orbax=None):
    """Save a tree (params, ``HMCState``, ``SGMCMCState``, optimizer state,
    ...) to ``path`` in the npz format (``.npz`` appended when missing).

    :param step: step number stored alongside.
    :param use_orbax: None or False; True raises, since the port writes
        the npz format only.
    :return: the file's path.
    """
    if use_orbax:
        raise ValueError(
            "The port writes checkpoints in the JAX package's npz format "
            "only (save_checkpoint(..., use_orbax=False) there), not with "
            "orbax.")
    arrays = {}
    exotic = {}  # leaf index -> [dtype name, shape] for npz-hostile dtypes
    paths = []
    for i, (p, leaf, in_fields) in enumerate(_flatten(state)):
        arr, meta = _to_numpy(leaf, in_fields)
        if meta is not None:
            exotic[i] = meta
        arrays["leaf_{}".format(i)] = arr
        paths.append(p)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(
        path,
        __paths__=np.frombuffer(json.dumps(paths).encode("utf-8"),
                                dtype=np.uint8),
        __exotic__=np.frombuffer(json.dumps(exotic).encode("utf-8"),
                                 dtype=np.uint8),
        __step__=np.asarray(step),
        **arrays,
    )
    return path + (".npz" if not path.endswith(".npz") else "")


def _rebuild_from_paths(paths, leaves):
    """Rebuild dict/list nesting from encoded paths; None when the tree
    holds NamedTuple or opaque nodes (the caller must pass ``like``)."""
    if any(kind not in ("d", "s") for path in paths for kind, _ in path):
        return None

    def insert(container, path, leaf):
        kind, key = path[0]
        if len(path) == 1:
            container[key] = leaf
            return
        child = container.get(key)
        if child is None:
            child = {}
            container[key] = child
        insert(child, path[1:], leaf)

    def finalize(node):
        if not isinstance(node, dict):
            return node
        if not node:  # empty container: dict is the only faithful guess
            return {}
        keys = sorted(node.keys(), key=lambda k: (str(type(k)), k))
        if all(isinstance(k, int) for k in keys):
            if keys != list(range(len(keys))):
                # A list/tuple with None entries was saved: None is
                # structure, not a leaf, so the indices have holes.
                raise ValueError(
                    "This checkpoint contains a sequence with None "
                    "entries (indices {}); pass `like=` (a template "
                    "state) to restore it faithfully.".format(keys))
            return [finalize(node[i]) for i in range(len(keys))]
        return {k: finalize(node[k]) for k in node}

    root: dict = {}
    for path, leaf in zip(paths, leaves):
        if not path:  # single-leaf tree
            return leaf
        insert(root, path, leaf)
    return finalize(root)


def _from_numpy(arr, meta):
    """A CPU tensor from a stored array and its exotic metadata."""
    if meta is not None:
        name, shape = meta
        if name not in _EXOTIC or _EXOTIC[name][0] is None:
            raise ValueError(
                "Checkpoint leaf of dtype {!r} has no torch counterpart."
                .format(name))
        dtype, view = _EXOTIC[name]
        raw = np.frombuffer(arr.tobytes(), dtype=view).reshape(shape)
        return torch.from_numpy(raw.copy()).view(dtype)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(path: str, like: Any = None, device=None):
    """Restore a tree saved by :func:`save_checkpoint` here or in the JAX
    package.

    :param like: optional template tree; the leaves are put into its
        structure (the leaf count is checked). Required for NamedTuple
        states; plain dict/list nesting restores without it (tuples come
        back as lists, ``None`` entries are omitted). A template leaf that
        is a tensor gets a tensor on its device, one that is a host int,
        float or bool gets that type, one that is a numpy array gets an
        array.
    :param device: where the leaves go without ``like`` (the card when
        None).
    :return: ``(state, step)``.
    """
    npz_path = path if path.endswith(".npz") else path + ".npz"
    if not os.path.isfile(npz_path):
        if os.path.isdir(path):
            raise ValueError(
                "{} is a directory, as orbax writes checkpoints; the port "
                "reads the npz format only: re-save it with "
                "save_checkpoint(..., use_orbax=False).".format(path))
        raise FileNotFoundError(npz_path)
    with np.load(npz_path, allow_pickle=False) as data:
        if "__treedef__" in data.files:
            raise ValueError(
                "This checkpoint uses the old pickled-treedef npz format "
                "(insecure; removed). Re-save it with the current "
                "save_checkpoint, or restore it with the release that "
                "wrote it.")
        paths = json.loads(data["__paths__"].tobytes().decode("utf-8"))
        step = int(data["__step__"])
        exotic = (json.loads(data["__exotic__"].tobytes().decode("utf-8"))
                  if "__exotic__" in data.files else {})
        leaves = [_from_numpy(data["leaf_{}".format(i)], exotic.get(str(i)))
                  for i in range(len(paths))]
    if like is not None:
        template = _flatten(like)
        if len(template) != len(leaves):
            raise ValueError(
                "Checkpoint has {} leaves but `like` template has {}."
                .format(len(leaves), len(template)))
        converted = []
        for (_, t, _), x in zip(template, leaves):
            if isinstance(t, torch.Tensor):
                converted.append(x.to(t.device))
            elif isinstance(t, (bool, int, float)):
                converted.append(type(t)(x.item()))
            elif isinstance(t, np.ndarray):
                converted.append(x.numpy())
            else:
                converted.append(x)
        return _unflatten(like, iter(converted)), step
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    rebuilt = _rebuild_from_paths(paths, [x.to(dev) for x in leaves])
    if rebuilt is None:
        raise ValueError(
            "This checkpoint contains NamedTuple/custom pytree nodes; pass "
            "`like=` (a template state) to restore its structure.")
    return rebuilt, step
