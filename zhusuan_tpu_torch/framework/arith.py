"""Arithmetic mixin making graph nodes behave like torch tensors.

Port of ``zhusuan_tpu/framework/arith.py`` (parity: reference
``zhusuan/utils.py:18-150``, ``TensorArithmeticMixin``). Python operators
delegate to ``self.tensor``, and ``__torch_function__`` unwraps nodes
passed to ``torch.*`` functions and tensor methods, so ``torch.sum(node)``
works as ``tf.reduce_sum(node)`` did in the reference.
"""

from __future__ import annotations

__all__ = ["TensorArithmeticMixin", "unwrap"]


def unwrap(x):
    """``x.tensor`` for a node, recursively inside lists, tuples and dicts;
    anything else unchanged."""
    if isinstance(x, TensorArithmeticMixin):
        return x.tensor
    if isinstance(x, (list, tuple)):
        return type(x)(unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: unwrap(v) for k, v in x.items()}
    return x


class TensorArithmeticMixin:
    """Mixin delegating arithmetic and indexing to ``self.tensor``."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*unwrap(tuple(args)), **unwrap(kwargs or {}))

    @property
    def shape(self):
        return self.tensor.shape

    @property
    def ndim(self):
        return self.tensor.ndim

    def __len__(self):
        return len(self.tensor)

    # -- unary --------------------------------------------------------- #
    def __abs__(self):
        return abs(self.tensor)

    def __neg__(self):
        return -self.tensor

    def __pos__(self):
        return +self.tensor

    # -- binary (forward and reflected) -------------------------------- #
    def __add__(self, other):
        return self.tensor + unwrap(other)

    def __radd__(self, other):
        return other + self.tensor

    def __sub__(self, other):
        return self.tensor - unwrap(other)

    def __rsub__(self, other):
        return other - self.tensor

    def __mul__(self, other):
        return self.tensor * unwrap(other)

    def __rmul__(self, other):
        return other * self.tensor

    def __truediv__(self, other):
        return self.tensor / unwrap(other)

    def __rtruediv__(self, other):
        return other / self.tensor

    def __floordiv__(self, other):
        return self.tensor // unwrap(other)

    def __rfloordiv__(self, other):
        return other // self.tensor

    def __mod__(self, other):
        return self.tensor % unwrap(other)

    def __rmod__(self, other):
        return other % self.tensor

    def __pow__(self, other):
        return self.tensor ** unwrap(other)

    def __rpow__(self, other):
        return other ** self.tensor

    def __matmul__(self, other):
        return self.tensor @ unwrap(other)

    def __rmatmul__(self, other):
        return other @ self.tensor

    # -- comparisons --------------------------------------------------- #
    def __lt__(self, other):
        return self.tensor < unwrap(other)

    def __le__(self, other):
        return self.tensor <= unwrap(other)

    def __gt__(self, other):
        return self.tensor > unwrap(other)

    def __ge__(self, other):
        return self.tensor >= unwrap(other)

    # __eq__/__ne__ stay object identity, as in the reference, which keeps
    # nodes hashable for dict membership (zhusuan/utils.py:118-127).

    # -- indexing ------------------------------------------------------ #
    def __getitem__(self, item):
        return self.tensor[item]

    def __iter__(self):
        raise TypeError(
            "{} object is not iterable.".format(type(self).__name__))

    def __bool__(self):
        raise TypeError(
            "Using a `{}` as a Python `bool` is not allowed.".format(
                type(self).__name__))
