"""Numerics guards (port of ``zhusuan_tpu/ops/checks.py``).

Parity: the reference wraps intermediate ops in ``tf.check_numerics``
behind a ``check_numerics=False`` flag on every continuous distribution
(e.g. ``zhusuan/distributions/univariate.py:101-111,179-180``).

Two tiers, as in the JAX package:

- :func:`check_numerics`: torch runs eagerly, so outside :func:`checked`
  the check raises at once; it reads the device's answer, which is a host
  synchronisation, and that is why it is opt-in.
- :func:`checked`: wraps a function so that every :func:`check_numerics`
  site inside it records into one device flag instead of reading the
  device, and (by default) a dispatch mode adds the counterpart of
  checkify's float checks: an op whose float output holds NaN when none of
  its inputs did. The flag is read once when the function returns, and the
  call raises ``FloatingPointError`` with the message of the first site
  that failed. A CUDA kernel writes its outputs through a raw pointer, out
  of the dispatch mode's sight, so every kernel launch records its own
  float check (:func:`record_kernel`).
"""

from __future__ import annotations

import contextvars
import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from zhusuan_tpu_torch.profiling import span

__all__ = ["check_numerics", "checked", "user_checks", "float_checks",
           "record_kernel"]

#: The error sets :func:`checked` takes (checkify's ``user_checks`` and
#: ``float_checks``): ``errors=user_checks | float_checks`` is the default.
user_checks = frozenset({"user"})
float_checks = frozenset({"float"})

# The recorder of the innermost checked() call, or None.
_ACTIVE = contextvars.ContextVar("zs_checked", default=None)

# Ops whose output is uninitialised memory: their NaNs are not made by the
# op, so the float checks skip them.
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "resize_", "set_")


def _device_of(flags):
    """The device to combine ``flags`` on: a CUDA one when any is there
    (moving a host flag to the card does not wait for the card; the other
    way would)."""
    return next((f.device for f in flags if f.is_cuda), flags[0].device)


_NONE = 2 ** 62  # "no site failed" in a recorder's device scalar


class _Recorder:
    """The failing sites of one :func:`checked` call: per device, the
    smallest index of a failing site as a device scalar (indices follow the
    sites' first appearance); the messages on the host."""

    def __init__(self, errors):
        self.user = "user" in errors
        self.float = "float" in errors
        self.messages = []
        self._index = {}
        self._first = {}

    def record(self, bad, message):
        i = self._index.get(message)
        if i is None:
            i = self._index[message] = len(self.messages)
            self.messages.append(message)
        first = self._first.get(bad.device)
        if first is None:
            first = torch.full((), _NONE, dtype=torch.int64,
                               device=bad.device)
        self._first[bad.device] = torch.where(
            bad, torch.clamp(first, max=i), first)

    def throw(self):
        if not self._first:
            return
        i = min(int(f) for f in self._first.values())  # the reads
        if i != _NONE:
            raise FloatingPointError(self.messages[i])


def _holds_nan(values):
    """A device bool: whether any float tensor of ``values`` holds NaN, or
    None when there is none; a NaN Python float counts (a fill value)."""
    flags = []
    for v in values:
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and v.numel():
                flags.append(torch.isnan(v).any())
        elif isinstance(v, float) and math.isnan(v):
            return True
    if not flags:
        return None
    dev = _device_of(flags)
    return torch.stack([f.to(dev) for f in flags]).any()


def _record_generated(recorder, before, after, message):
    """Record ``message`` where ``after`` (a device bool, or None) holds
    and ``before`` (a device bool, None or True) does not."""
    if after is None or before is True:
        return
    if before is not None:
        dev = _device_of([after, before])
        after = after.to(dev) & ~before.to(dev)
    recorder.record(after, message)


class _FloatChecks(TorchDispatchMode):
    """Records every op whose float output holds NaN when none of its
    inputs did (checked before the op runs, so an in-place op is judged by
    its input)."""

    def __init__(self, recorder):
        super().__init__()
        self.recorder = recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if name in _UNINITIALISED:
            return func(*args, **kwargs)
        before = _holds_nan(tree_leaves((args, kwargs)))
        out = func(*args, **kwargs)
        if before is not True:
            _record_generated(self.recorder, before,
                              _holds_nan(tree_leaves(out)),
                              "nan generated by primitive: {}.".format(func))
        return out


def record_kernel(name: str, inputs, outputs):
    """The float check of one kernel launch: inside a :func:`checked` call
    with ``float_checks``, record whether a float tensor of ``outputs``
    holds NaN when none of ``inputs`` did (device ops, no read), as "nan
    generated by kernel: ``name``". Every launch calls it
    (:func:`~._launch.launch_kernel`), since the kernel writes its outputs
    out of the dispatch mode's sight; outside :func:`checked` it costs one
    context-variable read.

    :param inputs, outputs: sequences of tensors (or None, skipped).
    """
    rec = _ACTIVE.get()
    if rec is None or not rec.float:
        return
    after = _holds_nan(outputs)
    if after is not None:
        _record_generated(rec, _holds_nan(inputs), after,
                          "nan generated by kernel: {}.".format(name))


def check_numerics(x, message: str, enabled: bool = True):
    """Return ``x``, flagging NaN or Inf (reference ``tf.check_numerics``).

    Outside :func:`checked` it raises ``FloatingPointError`` at once (a
    host read, a ``zs.sync.check_numerics`` span). Inside a
    :func:`checked` call it records into the call's device flag and raises
    when the call returns; with ``user_checks`` left out of the call's
    ``errors`` it does nothing. When ``enabled`` is False this is the
    identity.
    """
    if not enabled:
        return x
    rec = _ACTIVE.get()
    if rec is not None:
        if rec.user:
            rec.record(~torch.isfinite(x).all(),
                       "check_numerics failed for '{}': found NaN/Inf."
                       .format(message))
        return x
    with span("zs.sync.check_numerics"):
        finite = bool(torch.isfinite(x).all())
    if not finite:
        raise FloatingPointError(
            "check_numerics failed for {!r}: found NaN/Inf.".format(message))
    return x


def checked(fn, errors=None):
    """Wrap ``fn`` so that numeric failures raise deterministically, with
    one read of the device when ``fn`` returns (the counterpart of the JAX
    package's checkify tier).

    ``checked(fn)(*args)`` runs ``fn`` with every :func:`check_numerics`
    site recording into one device flag and, with ``float_checks``, under a
    dispatch mode that flags any op whose float output holds NaN when none
    of its inputs did. When ``fn`` returns, the flag is read and the call
    raises ``FloatingPointError`` with the message of the first failing
    site; otherwise it returns ``fn``'s output unchanged.

    Kernels: inside the call the kernels run as they do outside it (the
    JAX package's Pallas kernels run under checkify too). A CUDA kernel
    writes its outputs through a raw pointer the dispatch mode never sees,
    so each launch records its own float check (:func:`record_kernel`): a
    NaN in the kernel's float outputs when its float inputs held none
    raises "nan generated by kernel: <wrapper>". A kernel's intermediates
    are not checked: a NaN it makes and discards (an HMC proposal that
    diverged and was rejected) raises nothing, where the plain path's ops
    would flag it.

    :param errors: a subset of ``user_checks | float_checks`` (default:
        both).
    """
    errors = frozenset(user_checks | float_checks if errors is None
                       else errors)
    unknown = errors - (user_checks | float_checks)
    if unknown:
        raise ValueError(
            "errors must be a subset of user_checks | float_checks; got {}."
            .format(sorted(unknown)))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        rec = _Recorder(errors)
        token = _ACTIVE.set(rec)
        try:
            if rec.float:
                with _FloatChecks(rec):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)
        rec.throw()
        return out

    return wrapper
