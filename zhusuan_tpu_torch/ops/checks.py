"""Numerics guard (port of ``zhusuan_tpu/ops/checks.py::check_numerics``).

Parity: the reference wraps intermediate ops in ``tf.check_numerics``
behind a ``check_numerics=False`` flag on every continuous distribution
(e.g. ``zhusuan/distributions/univariate.py:101-111,179-180``). Torch runs
eagerly, so the check raises at once; it reads the device's answer, which
is a host synchronisation, and that is why it is opt-in.
"""

from __future__ import annotations

import torch

__all__ = ["check_numerics"]


def check_numerics(x, message: str, enabled: bool = True):
    """Return ``x``; raise ``FloatingPointError`` if it holds NaN or Inf.
    When ``enabled`` is False this is the identity."""
    if enabled and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(
            "check_numerics failed for {!r}: found NaN/Inf.".format(message))
    return x
