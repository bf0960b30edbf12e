"""Built-in densities that the port's CUDA kernels evaluate.

Every Pallas kernel of the JAX package traces the user's density into its
body. A CUDA kernel cannot trace a torch callable, so the port ships
closed-form densities whose parameters a kernel reads through pointers
(``csrc/densities.cuh`` holds their device side). Each is also a plain
``log_joint(obs)`` callable, so a sampler's plain path and the CPU tests
use it like any closure. Every kernel module names the built-ins its
kernel takes (``DENSITIES``); any other log-joint takes the plain path.

- :class:`DiagonalGaussianLogJoint`: the ``bench.py`` HMC and NUTS target.
- :class:`EquicorrelatedGaussianLogJoint`: the target of ``bench.py``'s
  ``measure_mixing`` (unit variances, every correlation ``rho``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "BuiltinDensity",
    "DiagonalGaussianLogJoint",
    "EquicorrelatedGaussianLogJoint",
]


class BuiltinDensity:
    """A closed-form ``log p(obs[name])`` over the last axis of one latent
    that the kernels evaluate in registers.

    :param name: the latent's name in the latent dict.
    :param dim: the size of the latent's last axis.
    """

    #: The density's id in the kernels' C interface (``csrc/densities.cuh``).
    kernel_id: int = -1

    def __init__(self, name: str, dim: int):
        self.name = name
        self.dim = int(dim)
        self._kernel_args = {}

    def log_prob(self, x):
        raise NotImplementedError

    def __call__(self, obs):
        return self.log_prob(obs[self.name])

    def _params(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The kernel's two parameter arrays (the second may be None)."""
        raise NotImplementedError

    def kernel_args(self, device) -> Tuple[torch.Tensor,
                                           Optional[torch.Tensor]]:
        """The kernel's parameter arrays, float32 and contiguous on
        ``device`` (cached per device)."""
        key = str(device)
        if key not in self._kernel_args:
            self._kernel_args[key] = tuple(
                None if v is None else
                v.to(device=device, dtype=torch.float32).contiguous()
                for v in self._params())
        return self._kernel_args[key]


class DiagonalGaussianLogJoint(BuiltinDensity):
    """``log p(obs[name]) = sum_j -0.5 (x_j - loc_j)^2 / scale_j^2`` over
    the last axis (normalising constant omitted, as in ``bench.py:72-74``).
    The kernel reads ``loc`` and ``inv_var = 1 / scale^2``.

    :param name: the latent's name in the latent dict.
    :param loc: ``[dim]`` tensor of means.
    :param scale: ``[dim]`` tensor of standard deviations.
    """

    kernel_id = 0

    def __init__(self, name: str, loc, scale):
        loc = torch.as_tensor(loc)
        scale = torch.as_tensor(scale, dtype=loc.dtype, device=loc.device)
        if loc.ndim != 1 or scale.shape != loc.shape:
            raise ValueError(
                "loc and scale must be 1-D tensors of one shape; got {} and "
                "{}.".format(tuple(loc.shape), tuple(scale.shape)))
        super().__init__(name, loc.shape[0])
        self.loc = loc
        self.scale = scale
        self.inv_var = 1.0 / torch.square(scale)

    def log_prob(self, x):
        return torch.sum(-0.5 * torch.square(x - self.loc) * self.inv_var,
                         dim=-1)

    def _params(self):
        return self.loc, self.inv_var


class EquicorrelatedGaussianLogJoint(BuiltinDensity):
    """The zero-mean Gaussian with unit variances and every correlation
    ``rho``, through its closed-form precision
    ``inv(rho 11^T + (1 - rho) I) = a I - b 11^T``:
    ``log p(z) = -0.5 (a sum(z^2) - b s^2)`` with ``s = sum(z)`` over the
    last axis (``bench.py:297-313``). ``a = 1 / (1 - rho)`` and
    ``b = rho / ((1 - rho)(1 + (dim - 1) rho))`` are computed in float64
    on the host, as ``bench.py:307-308`` does.

    It is evaluated in the centred arrangement of the same quadratic form,
    ``a sum(z^2) - b s^2 = a sum((z - s/d)^2) + c s^2`` with
    ``c = a/d - b = 1 / (d (1 + (d - 1) rho))`` (float64 on the host),
    whose two terms are never negative: in the bench's arrangement both
    are ~40 times ``log p`` at ``d = 100``, ``rho = 0.95``, and a float32
    evaluation loses ~1e-3 to cancellation. Its gradient
    ``-(a (z - s/d) + c s)`` is written out (:class:`_EquicorrelatedLogProb`)
    rather than taken by autograd. Both row sums are accumulated in
    float64, which is exact for float32 rows of the kernels' widths, and
    rounded to the input's dtype; the kernel does the same in registers, so
    the kernel and this plain version evaluate the same float32 values and
    their trajectories agree bit for bit. With float32 sums in two orders
    they drift apart along the slow direction, by 1.2e-4 after 190
    leapfrogs at ``d = 100`` (measured on an H100 80GB HBM3).

    :param name: the latent's name in the latent dict.
    :param dim: the size of the latent's last axis.
    :param rho: the correlation, in ``(-1 / (dim - 1), 1)``.
    """

    kernel_id = 1

    def __init__(self, name: str, dim: int, rho: float):
        dim, rho = int(dim), float(rho)
        if dim < 1:
            raise ValueError("dim must be >= 1; got {}.".format(dim))
        if not (rho < 1.0 and 1.0 + (dim - 1) * rho > 0.0):
            raise ValueError(
                "rho must lie in (-1/(dim-1), 1) for a positive definite "
                "covariance; got {} at dim {}.".format(rho, dim))
        super().__init__(name, dim)
        self.rho = rho
        self.a = float(1.0 / (1.0 - rho))
        self.b = float(rho / ((1.0 - rho) * (1.0 + (dim - 1) * rho)))
        self.c = float(1.0 / (dim * (1.0 + (dim - 1) * rho)))

    def log_prob(self, x):
        return _EquicorrelatedLogProb.apply(x, self.a, self.c,
                                            1.0 / self.dim)

    def _params(self):
        return torch.tensor([self.a, self.c, 1.0 / self.dim],
                            dtype=torch.float64), None


def _row_sum(x):
    """The sum over the last axis accumulated in float64 and rounded to
    ``x``'s dtype (as the kernels accumulate their row sums in double)."""
    return torch.sum(x, -1, dtype=torch.float64).to(x.dtype)


class _EquicorrelatedLogProb(torch.autograd.Function):
    """``-0.5 (a sum(r^2) + c s^2)`` with ``s = sum(x)``, ``r = x - s/d``,
    and its gradient ``-(a r + c s)``, in the kernel's arithmetic (``s/d``
    as ``s * inv_d``: torch divides a CUDA tensor by a scalar that way).
    The backward is made of differentiable ops, so second derivatives (the
    precision ``a I - b 11^T``) come out right."""

    @staticmethod
    def forward(ctx, x, a, c, inv_d):
        ctx.save_for_backward(x)
        ctx.consts = a, c, inv_d
        s = _row_sum(x)
        r = x - (s * inv_d)[..., None]
        return -0.5 * (a * _row_sum(r * r) + c * s * s)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a, c, inv_d = ctx.consts
        s = _row_sum(x)
        r = x - (s * inv_d)[..., None]
        grad = -(a * r + (c * s)[..., None])
        return g[..., None] * grad, None, None, None
