"""Framework utilities: the context stack binding ``observe`` scopes.

Port of ``zhusuan_tpu/framework/utils.py`` (parity: reference
``zhusuan/framework/utils.py:20-46``, ``Context``). The stack is
thread-local Python state that exists only while a model builder runs.
``reuse_variables`` is kept as a documented no-op: parameters are explicit
tensors passed into builders, so there is nothing to reuse implicitly;
``reuse`` is its deprecated alias.
"""

from __future__ import annotations

import functools
import threading
import warnings

__all__ = ["Context", "Local", "reuse_variables", "reuse"]


class Context:
    """A per-class thread-local context stack with ``with`` support."""

    _local = None  # set per subclass
    _init_lock = threading.Lock()

    @classmethod
    def _stack(cls):
        if cls.__dict__.get("_local") is None:
            # Double-checked under a lock: two threads racing to create the
            # threading.local would drop the loser's active stack mid-`with`.
            with Context._init_lock:
                if cls.__dict__.get("_local") is None:
                    cls._local = threading.local()
        if not hasattr(cls._local, "stack"):
            cls._local.stack = []
        return cls._local.stack

    def __enter__(self):
        type(self)._stack().append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        type(self)._stack().pop()

    @classmethod
    def get_context(cls):
        stack = cls._stack()
        if not stack:
            raise RuntimeError("No contexts on the stack.")
        return stack[-1]

    @classmethod
    def try_get_context(cls):
        stack = cls._stack()
        return stack[-1] if stack else None


class Local(Context):
    """The scope created by ``MetaBayesianNet.observe``: carries the
    observation dict, the owning meta net and the random key that
    ``BayesianNet`` instances constructed inside pick up (parity: reference
    ``framework/meta_bn.py:87-91``; the key is an int seed, see
    :class:`~zhusuan_tpu_torch.framework.bn.BayesianNet`), and optionally
    the nets' ``noise`` (a testing hook)."""

    def __init__(self, observations=None, meta_bn=None, key=None,
                 noise=None):
        self.observations = observations or {}
        self.meta_bn = meta_bn
        self.key = key
        self.noise = noise or {}


def reuse_variables(scope):
    """No-op parity shim for reference ``framework/utils.py:88-106``: the
    reference wrapped a builder in ``tf.make_template``; here parameters
    are explicit, so the decorator returns the builder unchanged in
    behaviour and is kept so reference code ports without edits."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return fn(*args, **kwargs)

        return wrapper

    return deco


def reuse(scope):
    """Deprecated alias of :func:`reuse_variables` (reference
    ``framework/utils.py:109-117`` keeps ``reuse`` exported with a
    deprecation warning pointing at ``reuse_variables``)."""
    warnings.warn(
        "zs.reuse is deprecated; use zs.reuse_variables instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    return reuse_variables(scope)
