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
- :class:`Toy2DLogJoint`: the funnel-like posterior of
  ``examples/toy_examples/toy2d_intractable.py`` over one latent
  ``[z1, z2]``; the ADVI trainer (:mod:`.advi_step`) alone takes it.
- :class:`TemperedLogJoint`: the tempered bridge ``(1 - beta) log p0 +
  beta log p1`` between two of the Gaussians above, ``beta`` a device
  scalar; annealed SMC's HMC moves take it, and K1 alone evaluates it.
- :class:`EightSchoolsLogJoint`, :class:`OrderedLogisticRegressionLogJoint`,
  :class:`WeibullAFTLogJoint` and :class:`CovarianceEstimationLogJoint`
  (:class:`LatentDictDensity`): the unconstrained posteriors of
  ``examples/hierarchical/eight_schools.py``,
  ``examples/robust_models/ordinal_regression.py``,
  ``survival_regression.py`` and ``examples/hierarchical/
  covariance_estimation.py``, over several latents and with the data they
  hold; the NUTS kernel alone evaluates them.
- :class:`WhitenedLogJoint`: ``log p(L y)`` of a diagonal or equicorrelated
  Gaussian under a dense preconditioner's Cholesky factor ``L``
  (``mcmc/precondition.py::whiten_log_joint`` of one).
- :class:`NealFunnelLogJoint`: Neal's funnel of
  ``examples/toy_examples/neal_funnel_neutra.py``.
- :class:`NeuTraLogJoint`: a Gaussian or the funnel pulled back through a
  RealNVP coupling flow, log-det included
  (``mcmc/neutra.py::neutra_log_joint`` of one).
- :class:`GaussianLinearRegressionLogJoint` (the regressions of
  ``examples/model_comparison/loo_compare.py``) and
  :class:`PoissonChangepointLogJoint` (``examples/state_space/
  changepoint.py``, the change point held per chain): data built-ins over
  one latent.
  The HMC transition's kernel (K1) alone evaluates these five.

Beside ``log_prob`` (plain torch ops, differentiable by autograd) each has
``value_and_grad``: the log-density and its gradient written out in the
arithmetic of ``csrc/densities.cuh``'s ``value_and_grad``, which the ADVI
trainer's kernel and its plain version both evaluate.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

__all__ = [
    "BuiltinDensity",
    "CovarianceEstimationLogJoint",
    "DiagonalGaussianLogJoint",
    "EightSchoolsLogJoint",
    "EquicorrelatedGaussianLogJoint",
    "GaussianLinearRegressionLogJoint",
    "LatentDictDensity",
    "NealFunnelLogJoint",
    "NeuTraLogJoint",
    "OrderedLogisticRegressionLogJoint",
    "PoissonChangepointLogJoint",
    "TemperedLogJoint",
    "Toy2DLogJoint",
    "WeibullAFTLogJoint",
    "WhitenedLogJoint",
]


class BuiltinDensity:
    """A closed-form ``log p(obs[name])`` over the last axis of one latent
    that the kernels evaluate in registers.

    :param name: the latent's name in the latent dict.
    :param dim: the size of the latent's last axis.
    """

    #: The density's id in the kernels' C interface (``csrc/densities.cuh``).
    kernel_id: int = -1
    #: Observed leaves the density reads per chain (``[n_chains, 1]`` each,
    #: a sampler's ``observed``), beside its latent.
    chain_observed: Tuple[str, ...] = ()

    def __init__(self, name: str, dim: int):
        self.name = name
        self.dim = int(dim)
        self._kernel_args = {}
        self._tables = {}

    def log_prob(self, x):
        raise NotImplementedError

    def __call__(self, obs):
        return self.log_prob(obs[self.name])

    def value_and_grad(self, x):
        """``(log p [...], d log p / dx [..., dim])`` at ``x [..., dim]`` in
        the kernels' arithmetic (no autograd graph is built or needed)."""
        raise NotImplementedError

    def kernel_ineligible(self) -> Optional[str]:
        """Why a kernel cannot evaluate this instance (None if it can): the
        limits of its device side (``csrc/densities.cuh``)."""
        return None

    def _params(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The kernel's two parameter arrays (the second may be None)."""
        raise NotImplementedError

    def _table(self, dtype, device):
        """The data table and constants in ``dtype`` on ``device``
        (cached): the float32 values the kernel reads, at float32 (the
        built-ins with data)."""
        key = (str(device), dtype)
        if key not in self._tables:
            table, consts = self._params()
            self._tables[key] = (
                table.to(device=device, dtype=dtype),
                [float(torch.tensor(float(c), dtype=dtype))
                 for c in consts])
        return self._tables[key]

    def aux_params(self) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
        """Two more parameter arrays of a composite built-in (a factor, a
        flow's weights), beside its base's :meth:`_params`; None here."""
        return None, None

    def kernel_args(self, device, aux: bool = False) -> Tuple[
            Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The kernel's parameter arrays (``aux``: :meth:`aux_params`'),
        float32 and contiguous on ``device`` (cached per device)."""
        key = (str(device), aux)
        if key not in self._kernel_args:
            self._kernel_args[key] = tuple(
                None if v is None else
                v.to(device=device, dtype=torch.float32).contiguous()
                for v in (self.aux_params() if aux else self._params()))
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

    def value_and_grad(self, x):
        # The row sum of log p is accumulated in float64 and rounded once
        # (exact at these widths), so the order of the kernel's warp
        # butterflies does not matter; log_prob above keeps its float32 sum,
        # which the HMC-family kernels reproduce within a tolerance.
        z = x - self.loc
        return (_row_sum(-0.5 * torch.square(z) * self.inv_var),
                -z * self.inv_var)

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

    def value_and_grad(self, x):
        s = _row_sum(x)
        r = x - (s * (1.0 / self.dim))[..., None]
        return (-0.5 * (self.a * _row_sum(r * r) + self.c * s * s),
                -(self.a * r + (self.c * s)[..., None]))

    def _params(self):
        return torch.tensor([self.a, self.c, 1.0 / self.dim],
                            dtype=torch.float64), None


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: the value a kernel gets
    when the host passes ``v`` in a float32 array."""
    return float(torch.tensor(v, dtype=torch.float32))


class Toy2DLogJoint(BuiltinDensity):
    """The funnel-like 2-D posterior of
    ``examples/toy_examples/toy2d_intractable.py`` (acceptance config #2)
    over ONE latent ``z = [z1, z2]``:
    ``log p(z) = log N(z2; 0, scale) + log N(z1; 0, exp(z2))``, normalising
    constants included, so it equals the log-joint of the two-node model
    ``z2 ~ N(0, scale)``, ``z1 ~ N(0, e^{z2})``. Gradient:
    ``d/dz1 = -z1 exp(-2 z2)``,
    ``d/dz2 = -z2 / scale^2 + z1^2 exp(-2 z2) - 1``.

    Only the ADVI trainer's kernel evaluates it (:data:`.advi_step.
    DENSITIES`); the samplers' kernels do not take it.

    :param name: the latent's name in the latent dict.
    :param scale: the standard deviation of ``z2`` (1.35 in the example).
    """

    kernel_id = 2

    def __init__(self, name: str, scale: float = 1.35):
        scale = float(scale)
        if not scale > 0.0:
            raise ValueError("scale must be positive; got {}.".format(scale))
        super().__init__(name, 2)
        self.scale = scale
        # float32 values on both sides: the kernel reads them from a float32
        # array, the plain version multiplies float32 tensors by them.
        self.const = _f32(-math.log(2.0 * math.pi) - math.log(scale))
        self.inv_var = _f32(1.0 / (scale * scale))
        self.half_inv_var = 0.5 * self.inv_var

    def log_prob(self, x):
        z1, z2 = x[..., 0], x[..., 1]
        return (self.const - self.half_inv_var * (z2 * z2) - z2
                - 0.5 * (z1 * z1) * torch.exp(-2.0 * z2))

    def value_and_grad(self, x):
        z1, z2 = x[..., 0], x[..., 1]
        z1p = z1 * torch.exp(-2.0 * z2)
        quad = z1 * z1p
        value = (self.const - self.half_inv_var * (z2 * z2) - z2) - 0.5 * quad
        g2 = (-(z2 * self.inv_var) + quad) - 1.0
        return value, torch.stack([-z1p, g2], dim=-1)

    def _params(self):
        return torch.tensor([self.const, self.half_inv_var, self.inv_var],
                            dtype=torch.float64), None


class TemperedLogJoint(BuiltinDensity):
    """The tempered bridge ``log f = (1 - beta) log p0 + beta log p1``
    between two built-in Gaussians over one latent: the target that
    annealed SMC's rejuvenation moves leave invariant at temperature
    ``beta`` (:class:`~zhusuan_tpu_torch.smc.AnnealedSMC`). ``beta`` may be
    a device scalar: the HMC kernel reads it on the card, so a ladder of
    temperatures never waits on the host. Only the HMC transition's kernel
    (:func:`.hmc_step.fused_hmc_step`) evaluates it.

    :param prior: the density at ``beta = 0``, a
        :class:`DiagonalGaussianLogJoint` or
        :class:`EquicorrelatedGaussianLogJoint`.
    :param target: the density at ``beta = 1``, one of the same two, over
        the same latent and dim.
    :param beta: the temperature, a scalar tensor or a float.
    """

    def __init__(self, prior: BuiltinDensity, target: BuiltinDensity, beta):
        parts = (DiagonalGaussianLogJoint, EquicorrelatedGaussianLogJoint)
        for role, d in (("prior", prior), ("target", target)):
            if not isinstance(d, parts):
                raise TypeError(
                    "the {} must be one of {}; got {!r}.".format(
                        role, [c.__name__ for c in parts], type(d)))
        if prior.name != target.name or prior.dim != target.dim:
            raise ValueError(
                "prior and target must be over one latent of one dim; got "
                "{!r} [{}] and {!r} [{}].".format(prior.name, prior.dim,
                                                  target.name, target.dim))
        super().__init__(target.name, target.dim)
        self.prior = prior
        self.target = target
        self.beta = beta

    def log_prob(self, x):
        return ((1.0 - self.beta) * self.prior.log_prob(x)
                + self.beta * self.target.log_prob(x))

    def value_and_grad(self, x):
        v0, g0 = self.prior.value_and_grad(x)
        v1, g1 = self.target.value_and_grad(x)
        w0 = 1.0 - self.beta
        return w0 * v0 + self.beta * v1, w0 * g0 + self.beta * g1


#: How far (relative to 1 + max |model log-density|) a built-in's gap to
#: its model's log-density may vary over the chains it is checked on:
#: float32 rounding of 100-term sums stays near 1e-6.
BUILTIN_GAP_RTOL = 1e-4


def check_tempered_pair(prior, target, latent_names, observed=()):
    """Check that ``prior`` and ``target`` make a :class:`TemperedLogJoint`
    (which raises on anything else) over the single latent
    ``latent_names`` lists, and that the sampler that moves it is given no
    observations ``observed`` (the built-ins hold their data); returns the
    pair."""
    TemperedLogJoint(prior, target, 0.0)
    if list(latent_names) != [target.name] or observed:
        raise ValueError(
            "the built-in densities need the single latent {!r} and no "
            "observations; got latent {} and observed {}.".format(
                target.name, list(latent_names), sorted(observed)))
    return prior, target


def check_builtin_gaps(checks, where: str, equal: bool = False):
    """Check, with one read of the device, that each built-in differs from
    its model's log-density by a constant (``equal``: by nothing) on the
    chains both were evaluated at (:data:`BUILTIN_GAP_RTOL`).

    :param checks: ``[(role, builtin_lp, model_lp)]``, ``[n]`` log-densities
        of one set of chains each.
    :param where: what the chains are, for the error message.
    :param equal: hold the values themselves, for a built-in that keeps its
        model's normalising constants.
    """
    stats = []
    for _, lp, model in checks:
        gap = lp - model
        stats += [gap.abs().max() if equal else gap.max() - gap.min(),
                  model.abs().max()]
    values = torch.stack([s.to(torch.float64) for s in stats]).tolist()
    for k, (role, _, _) in enumerate(checks):
        spread, scale = values[2 * k:2 * k + 2]
        if not spread <= BUILTIN_GAP_RTOL * (1.0 + scale):
            raise ValueError(
                "{} differs from its model's log-density{}: the gap {} {} "
                "over the {}.".format(
                    role, "" if equal else " by more than a constant",
                    "reaches" if equal else "spans", spread, where))


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


# -- built-ins over several latents, with data ------------------------- #
# The elementwise helpers below are written as csrc/densities.cuh writes
# them (softplus as max(u, 0) + log1p(exp(-|u|)), the logistic as
# 1 / (1 + exp(-u))), so that a float32 evaluation on the card gives the
# kernel's bits.


def _softplus(u):
    return torch.clamp(u, min=0.0) + torch.log1p(torch.exp(-torch.abs(u)))


def _log_sigmoid(u):
    return -(torch.clamp(-u, min=0.0) + torch.log1p(torch.exp(-torch.abs(u))))


def _sigmoid(u):
    return 1.0 / (1.0 + torch.exp(-u))


def _sum64(x):
    """The sum over the last axis in float64 (rounded by the caller once,
    with the other terms of the same total)."""
    return torch.sum(x, -1, dtype=torch.float64)


def _host64(v):
    """``v`` (a tensor, array or list) as a float64 CPU tensor of its own."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device="cpu", dtype=torch.float64)
    return torch.tensor(np.array(v, dtype=np.float64))


def _x_dot64(table_x, r):
    """``sum_i x[i, j] r[..., i]`` in float64: each product of two float32
    values is exact in double, and the sum is rounded by the caller once."""
    return torch.sum(r.double()[..., :, None] * table_x.double(), dim=-2)


class LatentDictDensity(BuiltinDensity):
    """A built-in log-density over several latents, with the data it holds.

    The NUTS sampler ravels a latent dict into one row a chain, in sorted
    name order (:class:`~zhusuan_tpu_torch.mcmc.nuts._Flattener`, the JAX
    package's ``_Flattener``); :meth:`log_prob` and :meth:`value_and_grad`
    take that row, and calling the density on a latent dict ravels it so.
    ``log_prob``'s gradient is the one written out in the kernel's
    arithmetic (:meth:`value_and_grad`), not autograd's. Every sum over the
    data, and the prior and Jacobian terms of the same total, is
    accumulated in float64 and rounded once, as the kernel accumulates its
    lanes' partial sums in double: the two then agree whatever their order
    of addition.

    The data reach the kernel as two float32 arrays (:meth:`kernel_args`):
    a table of ``n_rows`` rows and a few constants.

    :param shapes: ``{latent name: shape without the chain axis}``.
    :param held: ``{name: tensor}`` of the observations the density holds
        itself; a sampler's ``observed`` may name them (with these very
        tensors), and no other leaf.
    """

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], held=None):
        names = tuple(sorted(shapes))
        sizes = {k: int(np.prod(shapes[k], dtype=np.int64)) for k in names}
        super().__init__(None, sum(sizes.values()))
        self.names = names
        self.shapes = {k: tuple(shapes[k]) for k in names}
        self.sizes = sizes
        self.held = dict(held or {})

    @property
    def n_rows(self) -> int:
        """Rows of the data table."""
        return int(self._params()[0].shape[0])

    def holds(self, name, value) -> bool:
        """Whether ``value`` is the observation ``name`` this density
        holds."""
        return name in self.held and value is self.held[name]

    def ravel(self, obs) -> torch.Tensor:
        """The latents of ``obs`` as one ``[..., dim]`` row in sorted-name
        order; a key that is neither a latent nor a held observation
        raises."""
        for k, v in obs.items():
            if k not in self.shapes and not self.holds(k, v):
                raise ValueError(
                    "{} holds its data; {!r} is neither one of its latents "
                    "{} nor an observation it holds.".format(
                        type(self).__name__, k, list(self.names)))
        first = torch.as_tensor(obs[self.names[0]])
        lead = tuple(first.shape[:first.ndim - len(self.shapes[
            self.names[0]])])
        return torch.cat([
            torch.as_tensor(obs[k]).reshape(lead + (self.sizes[k],))
            for k in self.names], dim=-1)

    def __call__(self, obs):
        return self.log_prob(self.ravel(obs))

    def log_prob(self, x):
        return _LatentDictLogProb.apply(x, self)


class _LatentDictLogProb(torch.autograd.Function):
    """``density.value_and_grad(x, *extra)``'s value, with its written-out
    gradient (with respect to ``x`` alone) as the backward."""

    @staticmethod
    def forward(ctx, x, density, *extra):
        lp, g = density.value_and_grad(x, *extra)
        ctx.save_for_backward(g)
        ctx.n_extra = len(extra)
        return lp

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        (g,) = ctx.saved_tensors
        return (gout[..., None] * g, None) + (None,) * ctx.n_extra


def _written_out(density, x, *extra):
    """``density``'s log-density at ``x``: through
    :class:`_LatentDictLogProb` where autograd records (the gradient is
    the kernel's), else plainly (so that ``torch.func.vmap`` may batch
    it)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LatentDictLogProb.apply(x, density, *extra)
    return density.value_and_grad(x, *extra)[0]


class EightSchoolsLogJoint(LatentDictDensity):
    """The eight-schools posterior of ``examples/hierarchical/
    eight_schools.py`` in its unconstrained space: ``transform_log_joint(
    make_log_joint(), {"tau": Softplus()})[0]`` (or of
    ``make_centered_log_joint`` when ``centered``), Jacobian included.

    Latents, in sorted order: ``mu`` and ``tau`` (scalars a chain; ``tau``
    unconstrained, the scale is ``softplus(tau)``), then ``theta_tilde``
    (non-centred, ``theta = mu + scale * theta_tilde``) or ``theta``
    (centred), ``[J]``. The density: ``mu ~ N(0, 100)`` (without its
    constant), ``scale ~ HalfCauchy(5)``, ``theta_tilde ~ N(0, 1)`` or
    ``theta ~ N(mu, scale)`` (with ``-log scale``), ``y_j ~ N(theta_j,
    sigma_j)`` (without constants), plus ``log sigmoid(tau)``.

    Data table ``[J, 2]``: ``y_j`` and ``1 / sigma_j``; constants
    ``(log(2/pi) - log 5, 1/5, 1/100)``.
    """

    #: Largest J the kernel takes (``2 + J <= 16`` elements a row).
    MAX_SCHOOLS = 14

    def __init__(self, y, sigma, centered: bool = False):
        y, sigma = _host64(y), _host64(sigma)
        if y.ndim != 1 or sigma.shape != y.shape or y.shape[0] < 1:
            raise ValueError(
                "y and sigma must be 1-D of one length; got {} and "
                "{}.".format(tuple(y.shape), tuple(sigma.shape)))
        self.centered = bool(centered)
        self.theta_name = "theta" if self.centered else "theta_tilde"
        super().__init__({"mu": (), "tau": (),
                          self.theta_name: (y.shape[0],)})
        self.y, self.sigma = y, sigma
        self.kernel_id = 4 if self.centered else 3

    def kernel_ineligible(self):
        if self.y.shape[0] > self.MAX_SCHOOLS:
            return "the kernel takes at most {} schools; got {}".format(
                self.MAX_SCHOOLS, self.y.shape[0])
        return None

    def _params(self):
        table = torch.stack([self.y, 1.0 / self.sigma], dim=-1)
        consts = torch.tensor([math.log(2.0 / math.pi) - math.log(5.0),
                               1.0 / 5.0, 1.0 / 100.0], dtype=torch.float64)
        return table, consts

    def value_and_grad(self, x):
        table, (c_hc, s_inv, m_inv) = self._table(x.dtype, x.device)
        yv, isig = table[:, 0], table[:, 1]
        mu, u, rest = x[..., 0], x[..., 1], x[..., 2:]
        tau = _softplus(u)
        sg, sgm = _sigmoid(u), _sigmoid(-u)
        t5 = tau * s_inv
        lp_hc = c_hc - torch.log1p(t5 * t5)
        g_hc = -(2.0 * (t5 * s_inv)) / (1.0 + t5 * t5)
        mu_s = mu * m_inv
        lp_prior = (-0.5 * (mu_s * mu_s)).double() + lp_hc.double() \
            + _log_sigmoid(u).double()
        g_mu_prior = -(mu_s * m_inv)
        if self.centered:
            itau = (1.0 / tau)[..., None]
            a = (rest - mu[..., None]) * itau
            z = (yv - rest) * isig
            r = z * isig
            v = (-0.5 * (a * a) - torch.log(tau)[..., None]) \
                + (-0.5 * (z * z))
            lp = (_sum64(v) + lp_prior).to(x.dtype)
            ait = a * itau
            g_mu = (_sum64(ait) + g_mu_prior.double()).to(x.dtype)
            g_tau = (_sum64((a * a) * itau - itau)
                     + g_hc.double()).to(x.dtype)
            g_rest = r - ait
        else:
            theta = mu[..., None] + tau[..., None] * rest
            z = (yv - theta) * isig
            r = z * isig
            lp = (_sum64(-0.5 * (z * z)) + _sum64(-0.5 * (rest * rest))
                  + lp_prior).to(x.dtype)
            g_mu = (_sum64(r) + g_mu_prior.double()).to(x.dtype)
            g_tau = (_sum64(r.double() * rest.double())
                     + g_hc.double()).to(x.dtype)
            g_rest = tau[..., None] * r - rest
        g_u = g_tau * sg + sgm
        return lp, torch.cat([g_mu[..., None], g_u[..., None], g_rest],
                             dim=-1)


class OrderedLogisticRegressionLogJoint(LatentDictDensity):
    """The ordinal regression posterior of ``examples/robust_models/
    ordinal_regression.py`` in its unconstrained space:
    ``transform_log_joint(build_log_joint(x, y), {"cuts": Ordered()})[0]``.

    Latents, in sorted order: ``beta [p]`` and ``cuts [K - 1]``
    (unconstrained ``u``; the cutpoints are ``c_0 = u_0``,
    ``c_k = c_{k-1} + exp(u_k)``). The density: ``beta ~ N(0, 1)`` and
    ``c ~ N(0, 2^2)`` without constants, the ``Ordered`` Jacobian
    ``sum(u[1:])``, and for each row ``OrderedLogistic(x_i^T beta,
    c).log_prob(y_i)`` term for term as
    :class:`~zhusuan_tpu_torch.distributions.OrderedLogistic` computes it.

    Data table ``[n, p + 1]``: ``x_i`` and ``y_i``; constants ``(p, K - 1,
    finfo(float32).max / 2)``.

    :param x: ``[n, p]`` covariates.
    :param y: ``[n]`` categories in ``0 .. n_categories - 1``.
    """

    #: The kernel's limits: ``p <= 4``, ``K - 1 <= 8``, ``p + K - 1 <= 12``.
    MAX_P, MAX_CUTS, MAX_DIM = 4, 8, 12

    kernel_id = 5

    def __init__(self, x, y, n_categories: int):
        x = _host64(x)
        y = (y.detach().cpu() if isinstance(y, torch.Tensor)
             else torch.tensor(np.array(y)))
        n_categories = int(n_categories)
        if x.ndim != 2 or y.shape != x.shape[:1]:
            raise ValueError("x must be [n, p] and y [n]; got {} and "
                             "{}.".format(tuple(x.shape), tuple(y.shape)))
        if n_categories < 2:
            raise ValueError("n_categories must be >= 2.")
        if y.is_floating_point() and not bool((y == torch.round(y)).all()):
            raise ValueError("y must hold category indices.")
        y = y.to(torch.int64)
        if bool((y < 0).any()) or bool((y >= n_categories).any()):
            raise ValueError("y must lie in 0 .. {}.".format(
                n_categories - 1))
        self.p, self.n_cuts = int(x.shape[1]), n_categories - 1
        super().__init__({"beta": (self.p,), "cuts": (self.n_cuts,)})
        self.x, self.y, self.n_categories = x, y, n_categories

    def kernel_ineligible(self):
        if (self.p > self.MAX_P or self.n_cuts > self.MAX_CUTS
                or self.dim > self.MAX_DIM):
            return ("the kernel takes p <= {}, K - 1 <= {} and p + K - 1 <= "
                    "{}; got p {}, K - 1 {}".format(
                        self.MAX_P, self.MAX_CUTS, self.MAX_DIM, self.p,
                        self.n_cuts))
        return None

    def _params(self):
        table = torch.cat([self.x, self.y.to(torch.float64)[:, None]], -1)
        consts = torch.tensor([self.p, self.n_cuts,
                               float(torch.finfo(torch.float32).max) / 2],
                              dtype=torch.float64)
        return table, consts

    def value_and_grad(self, x):
        table, _ = self._table(x.dtype, x.device)
        p, nc = self.p, self.n_cuts
        big = torch.finfo(x.dtype).max / 2
        tx = table[:, :p]
        yi = table[:, p].to(torch.int64)
        beta, u = x[..., :p], x[..., p:]
        cuts = [u[..., 0]]
        for k in range(1, nc):
            cuts.append(cuts[-1] + torch.exp(u[..., k]))
        c = torch.stack(cuts, dim=-1)
        eta = beta[..., 0, None] * tx[:, 0]
        for j in range(1, p):
            eta = eta + beta[..., j, None] * tx[:, j]
        pad = torch.ones_like(c[..., :1])
        padded = torch.cat([-big * pad, c, big * pad], dim=-1)
        table_c = padded[..., None, :].expand(eta.shape + (nc + 2,))
        hi = torch.gather(table_c, -1, (yi + 1).expand(eta.shape)[..., None])
        lo = torch.gather(table_c, -1, yi.expand(eta.shape)[..., None])
        a, b = hi[..., 0] - eta, lo[..., 0] - eta
        d = b - a
        lp_row = (_log_sigmoid(a) + _log_sigmoid(-b)) + torch.log(
            -torch.expm1(torch.clamp(d, max=-1e-12)))
        inv_em = torch.where(d < -1e-12, 1.0 / torch.expm1(a - b),
                             torch.zeros_like(d))
        s_na = 1.0 / (1.0 + torch.exp(a))
        s_b = 1.0 / (1.0 + torch.exp(-b))
        ga = s_na + inv_em
        gb = -s_b - inv_em
        geta = s_b - s_na
        c_half = c * 0.5
        lp = (_sum64(lp_row) + _sum64(-0.5 * (beta * beta))
              + _sum64(-0.5 * (c_half * c_half)) + _sum64(u[..., 1:])
              ).to(x.dtype)
        g_beta = (_x_dot64(tx, geta) + (-beta).double()).to(x.dtype)
        zero = torch.zeros_like(ga)
        g_c = [(_sum64(torch.where(yi == k, ga, zero))
                + _sum64(torch.where(yi == k + 1, gb, zero))
                + (-(c_half[..., k] * 0.5)).double()).to(x.dtype)
               for k in range(nc)]
        # Through the Ordered bijector: d/du_k = exp(u_k) sum_{m >= k} g_c_m
        # (+1 from the Jacobian) for k >= 1, and sum_m g_c_m for k = 0.
        tail = g_c[-1]
        g_u = [None] * nc
        for k in range(nc - 1, -1, -1):
            if k < nc - 1:
                tail = g_c[k] + tail
            g_u[k] = tail if k == 0 else torch.exp(u[..., k]) * tail + 1.0
        return lp, torch.cat([g_beta, torch.stack(g_u, dim=-1)], dim=-1)


class WeibullAFTLogJoint(LatentDictDensity):
    """The Weibull accelerated-failure-time posterior of
    ``examples/robust_models/survival_regression.py`` in its unconstrained
    space: ``transform_log_joint(build_log_joint(x, y, c), {"k":
    Softplus()})[0]`` with ``observed={"y": y}``.

    Latents, in sorted order: ``beta [p]`` and ``k`` (a scalar a chain,
    unconstrained; the shape is ``softplus(k)``). With ``eta_i = x_i^T
    beta`` and ``z_i = log(s_i) - eta_i``, ``s_i`` the event time where
    ``y_i < c_i`` and the censor time where censored: a row scores
    ``log k - eta_i + (k - 1) z_i - exp(k z_i)`` (the event density) or
    ``-exp(k z_i)`` (the survival mass); priors ``k ~ N(1, 1)`` and
    ``beta ~ N(0, 1)`` without constants, plus ``log sigmoid(k_u)``. The
    density holds ``y`` (:attr:`held`).

    Data table ``[n, p + 2]``: ``x_i``, ``log s_i`` and the event flag; no
    constants but ``p``.

    :param x: ``[n, p]`` covariates.
    :param y: ``[n]`` observed times ``min(T_i, c_i)``.
    :param censor: ``[n]`` censor times ``c_i``.
    """

    #: The kernel's limit: ``p + 1 <= 9`` elements a row.
    MAX_P = 8

    kernel_id = 6

    def __init__(self, x, y, censor):
        y_held = y
        x, y, censor = _host64(x), _host64(y), _host64(censor)
        if x.ndim != 2 or y.shape != x.shape[:1] or censor.shape != y.shape:
            raise ValueError(
                "x must be [n, p], y and censor [n]; got {}, {} and "
                "{}.".format(tuple(x.shape), tuple(y.shape),
                             tuple(censor.shape)))
        self.p = int(x.shape[1])
        super().__init__({"beta": (self.p,), "k": ()},
                         held={"y": y_held} if isinstance(
                             y_held, torch.Tensor) else None)
        self.x, self.y, self.censor = x, y, censor
        self.event = y < censor

    def kernel_ineligible(self):
        if self.p > self.MAX_P:
            return "the kernel takes p <= {}; got {}".format(self.MAX_P,
                                                             self.p)
        return None

    def _params(self):
        tiny = float(torch.finfo(torch.float64).tiny)
        s = torch.where(self.event, torch.clamp(self.y, min=tiny),
                        self.censor)
        table = torch.cat([self.x, torch.log(s)[:, None],
                           self.event.to(torch.float64)[:, None]], -1)
        return table, torch.tensor([self.p], dtype=torch.float64)

    def value_and_grad(self, x):
        table, _ = self._table(x.dtype, x.device)
        p = self.p
        tx, ls, ev = table[:, :p], table[:, p], table[:, p + 1]
        event = ev > 0.5
        beta, u = x[..., :p], x[..., p]
        k = _softplus(u)
        sg, sgm = _sigmoid(u), _sigmoid(-u)
        logk, ik = torch.log(k)[..., None], (1.0 / k)[..., None]
        kk = k[..., None]
        eta = beta[..., 0, None] * tx[:, 0]
        for j in range(1, p):
            eta = eta + beta[..., j, None] * tx[:, j]
        z = ls - eta
        e = torch.exp(kk * z)
        lp_row = torch.where(event, ((logk - eta) + (kk - 1.0) * z) - e, -e)
        r = kk * (e - ev)
        dk = torch.where(event, ik + z, torch.zeros_like(z)) - z * e
        km1 = k - 1.0
        lp = (_sum64(lp_row) + _sum64(-0.5 * (beta * beta))
              + (-0.5 * (km1 * km1)).double()
              + _log_sigmoid(u).double()).to(x.dtype)
        g_beta = (_x_dot64(tx, r) + (-beta).double()).to(x.dtype)
        g_k = (_sum64(dk) + (-km1).double()).to(x.dtype)
        g_u = g_k * sg + sgm
        return lp, torch.cat([g_beta, g_u[..., None]], dim=-1)


def _tril_pairs(k: int):
    """The strict lower triangle's ``(row, column)`` pairs of a ``[k, k]``
    matrix, row-major (``np.tril_indices(k, -1)``: CorrelationCholesky's
    order)."""
    return [(i, j) for i in range(k) for j in range(i)]


class CovarianceEstimationLogJoint(LatentDictDensity):
    """The covariance posterior of ``examples/hierarchical/
    covariance_estimation.py`` in its unconstrained space:
    ``transform_log_joint(build_log_joint(x), {"s": Softplus(), "L":
    CorrelationCholesky()})[0]``, Jacobians included.

    Latents, in sorted order: ``L [K(K-1)/2]`` (unconstrained ``y``; the
    partial correlations are ``z = tanh(y)`` row-major in the strict lower
    triangle, and the correlation factor ``L`` is CorrelationCholesky's)
    and ``s [K]`` (unconstrained ``u``; the scales are ``softplus(u)``).
    The model: ``s_a ~ HalfNormal(1)`` (without its constant), ``L ~
    LKJCholesky(K, eta)``, ``x_i ~ N(0, diag(s) L L^T diag(s))``.

    It is evaluated in closed form. The data enter only through ``n`` and
    the scatter matrix ``S = sum_i x_i x_i^T`` (formed in float64 on the
    host; the kernel reads it rounded to float32 once):
    ``sum_i ||L^-1 diag(1/s) x_i||^2 = tr(W M W^T)`` with ``W = L^-1`` and
    ``M = diag(1/s) S diag(1/s)``, so a leaf costs O(K^3) whatever ``n``
    is. The LKJ density, CorrelationCholesky's Jacobian and ``-n sum log
    diag L`` reduce together to ``sum_{i>j} (a_j - n/2) log(1 - z_ij^2)``
    plus a constant ``C``, with ``a_j = eta + (K - 2 - j)/2`` and
    ``log L_ii = 1/2 sum_{k<i} log(1 - z_ik^2)``:

        log p = sum_a (-s_a^2 / 2 + log sigmoid(u_a) - n log s_a)
                - tr(W M W^T) / 2 + sum_{i>j} (a_j - n/2) log(1 - z_ij^2)
                + C.

    The closure scores ``-inf`` (or NaN) where a partial correlation rounds
    to +-1 (``log1p(-z^2) = -inf``) or a diagonal entry of ``L`` underflows
    to 0 (LKJ's support mask); this density then gives ``-inf`` and a zero
    gradient, so NUTS sees the same divergence.

    Its gradient is written out (:meth:`value_and_grad`) in the arithmetic
    of ``csrc/densities.cuh``'s ``CovarianceEstimation``: with ``G = W^T W
    M W^T`` (minus half ``dQ/dL``, ``Q = tr(W M W^T)``), ``d/dy_ik =
    (1 - z_ik^2) G_ik r_ik - z_ik sum_{k<j<=i} G_ij L_ij - 2 (a_k - n/2)
    z_ik`` (``r_ik = L_ik / z_ik``, the stick remainder), and ``d/ds_a =
    -s_a - n/s_a + (W^T W M)_aa / s_a``, through Softplus. Every sum is
    accumulated in float64 in a fixed order and rounded once.

    Data table ``[1, K * K]``: ``S``; constants ``(K, n, C, a_0 - n/2, ...,
    a_{K-2} - n/2)``.

    :param x: ``[n, K]`` observations (K >= 2).
    :param eta: the LKJ concentration.
    """

    #: Largest K the kernel takes (``K (K + 1) / 2 <= 16`` elements a row).
    MAX_K = 5

    kernel_id = 7

    def __init__(self, x, eta: float = 2.0):
        x = _host64(x)
        if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 2:
            raise ValueError("x must be [n, K] with n >= 1 and K >= 2; got "
                             "{}.".format(tuple(x.shape)))
        self.n_obs, self.k = int(x.shape[0]), int(x.shape[1])
        self.eta = float(eta)
        if not self.eta > 0.0:
            raise ValueError("eta must be positive; got {}.".format(eta))
        k = self.k
        super().__init__({"L": (k * (k - 1) // 2,), "s": (k,)})
        self.scatter = x.T @ x
        a = [self.eta + 0.5 * (k - 2 - j) for j in range(k - 1)]
        self.const = -sum(
            (k - 1 - j) * ((2.0 * a[j] - 1.0) * math.log(2.0)
                           + 2.0 * math.lgamma(a[j]) - math.lgamma(2.0 * a[j]))
            for j in range(k - 1))
        self.coef = [a[j] - 0.5 * self.n_obs for j in range(k - 1)]

    def kernel_ineligible(self):
        if self.k > self.MAX_K:
            return "the kernel takes K <= {}; got {}".format(self.MAX_K,
                                                            self.k)
        return None

    def _params(self):
        table = self.scatter.reshape(1, self.k * self.k)
        consts = torch.tensor([self.k, self.n_obs, self.const] + self.coef,
                              dtype=torch.float64)
        return table, consts

    def value_and_grad(self, x):
        table, consts = self._table(x.dtype, x.device)
        k, m = self.k, self.k * (self.k - 1) // 2
        n, c0, coef = consts[1], consts[2], consts[3:]
        S = table[0]

        def d(v):
            return v.double()

        pairs = _tril_pairs(k)
        u = [x[..., m + a] for a in range(k)]
        sp = [_softplus(v) for v in u]
        sg = [_sigmoid(v) for v in u]
        sgm = [_sigmoid(-v) for v in u]
        isp = [1.0 / v for v in sp]
        z, lz, om = {}, {}, {}
        for e, (i, j) in enumerate(pairs):
            z[i, j] = torch.tanh(x[..., e])
            zz = z[i, j] * z[i, j]
            lz[i, j] = torch.log1p(-zz)
            om[i, j] = 1.0 - zz
        # CorrelationCholesky's factor, row by row: r_ij = exp(p_ij / 2)
        # with p_ij the sum of the row's log(1 - z^2) before column j.
        r, L = {}, {}
        for i in range(k):
            p = torch.zeros_like(u[0])
            for j in range(i):
                r[i, j] = torch.exp(0.5 * p)
                L[i, j] = z[i, j] * r[i, j]
                p = p + lz[i, j]
            r[i, i] = torch.exp(0.5 * p)
            L[i, i] = r[i, i]
        bad = torch.zeros_like(u[0], dtype=torch.bool)
        for key in pairs:
            bad = bad | ~(lz[key] > -math.inf)
        for i in range(k):
            bad = bad | ~(L[i, i] > 0.0)
        # W = L^-1 by forward substitution.
        W = {}
        for i in range(k):
            W[i, i] = 1.0 / L[i, i]
            for j in range(i):
                acc = d(L[i, j]) * d(W[j, j])
                for q in range(j + 1, i):
                    acc = acc + d(L[i, q]) * d(W[q, j])
                W[i, j] = -acc.to(x.dtype) * W[i, i]
        M = {}
        for a in range(k):
            for b in range(a, k):
                M[a, b] = (S[a * k + b] * isp[a]) * isp[b]
                M[b, a] = M[a, b]
        T = {}  # W M
        for i in range(k):
            for b in range(k):
                acc = d(W[i, 0]) * d(M[0, b])
                for q in range(1, i + 1):
                    acc = acc + d(W[i, q]) * d(M[q, b])
                T[i, b] = acc.to(x.dtype)
        V = {}  # W M W^T
        for i in range(k):
            for j in range(k):
                acc = d(T[i, 0]) * d(W[j, 0])
                for q in range(1, j + 1):
                    acc = acc + d(T[i, q]) * d(W[j, q])
                V[i, j] = acc.to(x.dtype)
        quad = None
        for i in range(k):
            for q in range(i + 1):
                t = d(T[i, q]) * d(W[i, q])
                quad = t if quad is None else quad + t
        lp = None
        for a in range(k):
            t = d(-0.5 * (sp[a] * sp[a]))
            lp = t if lp is None else lp + t
            lp = lp + d(_log_sigmoid(u[a]))
            lp = lp - n * d(torch.log(sp[a]))
        lp = lp - 0.5 * quad
        for (i, j) in pairs:
            lp = lp + coef[j] * d(lz[i, j])
        lp = lp + c0
        # -dQ/2 / ds_a through Softplus, with h_a = (W^T W M)_aa.
        g_u = []
        for a in range(k):
            h = d(W[a, a]) * d(T[a, a])
            for q in range(a + 1, k):
                h = h + d(W[q, a]) * d(T[q, a])
            acc = -d(sp[a]) - n * d(isp[a])
            acc = acc + d(isp[a]) * h
            g_u.append(acc.to(x.dtype) * sg[a] + sgm[a])
        # G = W^T V (lower triangle, diagonal included), in float64.
        G = {}
        for i in range(k):
            for j in range(i + 1):
                acc = d(W[i, i]) * d(V[i, j])
                for q in range(i + 1, k):
                    acc = acc + d(W[q, i]) * d(V[q, j])
                G[i, j] = acc
        g_y = []
        for (i, j) in pairs:
            acc = (d(om[i, j]) * G[i, j]) * d(r[i, j])
            s_acc = G[i, j + 1] * d(L[i, j + 1])
            for q in range(j + 2, i + 1):
                s_acc = s_acc + G[i, q] * d(L[i, q])
            acc = acc - d(z[i, j]) * s_acc
            acc = acc - (2.0 * coef[j]) * d(z[i, j])
            g_y.append(acc.to(x.dtype))
        grad = torch.stack(g_y + g_u, dim=-1)
        lp = torch.where(bad, torch.full_like(lp, -math.inf), lp)
        grad = torch.where(bad[..., None], torch.zeros_like(grad), grad)
        return lp.to(x.dtype), grad


# -- built-ins of the HMC transition's kernel alone (K1) ----------------- #
# Each sum is taken in the kernel's order (csrc/densities.cuh), so that a
# float32 evaluation on the card gives the kernel's bits: a product of a
# matrix and a vector adds its products pairwise over the columns padded
# with zeros to a power of two, ((0 + 1) + (2 + 3)) + ..., as the kernel's
# recursive tree does; a sum over a warp's 32 lanes adds the halves, lane
# u to lane u + 16 first, as the kernel's butterfly does; a sum over a
# chain's elements or data rows is accumulated in float64 and rounded once.


def _pairwise_matvec(mat, v):
    """``sum_k mat[j, k] v[..., k]`` for every row ``j``: the products
    rounded in ``v``'s dtype, then added pairwise (see above)."""
    p = mat * v[..., None, :]
    n_in = p.shape[-1]
    width = 1 << max(n_in - 1, 0).bit_length()
    if width > n_in:
        p = torch.nn.functional.pad(p, (0, width - n_in))
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _butterfly_sum(p):
    """The sum over the last axis of 32 (a warp's lanes), halves first."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def _rounded(values, dtype):
    """Host constants rounded to ``dtype`` (what the kernel reads, in
    float32)."""
    return [float(torch.tensor(float(v), dtype=dtype)) for v in values]


class WhitenedLogJoint(BuiltinDensity):
    """``log p_base(L y)`` over the whitened latent ``y``, with gradient
    ``L^T grad p_base(L y)``: dense-mass HMC on ``q = L y`` as identity-mass
    HMC on ``y`` (:func:`~zhusuan_tpu_torch.mcmc.whiten_log_joint`).

    ``L y`` and ``L^T g`` are taken in the kernel's pairwise order
    (:func:`_pairwise_matvec`); the base's value and gradient are its
    :meth:`~BuiltinDensity.value_and_grad` (its row sums in float64), so
    the kernel and this plain version evaluate the same float32 values.

    :param base: a :class:`DiagonalGaussianLogJoint` or
        :class:`EquicorrelatedGaussianLogJoint` over the latent.
    :param chol: ``[dim, dim]`` lower-triangular Cholesky factor ``L``
        (read whole: an upper triangle is used as given, as by ``y @ L^T``).
    """

    #: The kernel keeps ``L`` and a chain's row in shared memory.
    MAX_DIM = 128

    kernel_id = 8

    def __init__(self, base: BuiltinDensity, chol):
        parts = (DiagonalGaussianLogJoint, EquicorrelatedGaussianLogJoint)
        if not isinstance(base, parts):
            raise TypeError("the base must be one of {}; got {!r}.".format(
                [c.__name__ for c in parts], type(base)))
        chol = torch.as_tensor(chol)
        if tuple(chol.shape) != (base.dim, base.dim):
            raise ValueError("chol must be [{0}, {0}]; got {1}.".format(
                base.dim, tuple(chol.shape)))
        super().__init__(base.name, base.dim)
        self.base = base
        self.chol = chol

    def kernel_ineligible(self):
        if self.dim > self.MAX_DIM:
            return "the whitened density takes dim <= {}; got {}".format(
                self.MAX_DIM, self.dim)
        return None

    def log_prob(self, y):
        return _written_out(self, y)

    def value_and_grad(self, y):
        chol = self.chol.to(device=y.device, dtype=y.dtype)
        lp, g = self.base.value_and_grad(_pairwise_matvec(chol, y))
        return lp, _pairwise_matvec(chol.T, g)

    def _params(self):
        return self.base._params()

    def aux_params(self):
        return self.chol, None


class NealFunnelLogJoint(BuiltinDensity):
    """Neal's funnel over one latent ``z = [v, x_1 .. x_{dim-1}]``
    (``examples/toy_examples/neal_funnel_neutra.py:23-33``):
    ``log p = -0.5 (v / s)^2 + sum_i (-0.5 (x_i e^{-v/2})^2 - v / 2)``, no
    normalising constant. Gradient: ``d/dx_i = -x_i e^{-v}``,
    ``d/dv = -v / s^2 + sum_i (0.5 (x_i e^{-v/2})^2 - 0.5)``; ``1 / s`` is
    a constant the kernel reads in float32, and the sums over ``i`` are
    accumulated in float64 and rounded once.

    :param name: the latent's name in the latent dict.
    :param dim: the size of the latent's last axis (>= 2).
    :param v_scale: the standard deviation ``s`` of ``v``.
    """

    kernel_id = 9

    def __init__(self, name: str, dim: int, v_scale: float = 3.0):
        dim, v_scale = int(dim), float(v_scale)
        if dim < 2:
            raise ValueError("the funnel needs dim >= 2; got {}.".format(dim))
        if not v_scale > 0.0:
            raise ValueError("v_scale must be positive; got {}.".format(
                v_scale))
        super().__init__(name, dim)
        self.v_scale = v_scale

    def log_prob(self, z):
        return _written_out(self, z)

    def value_and_grad(self, z):
        (inv_s,) = _rounded([1.0 / self.v_scale], z.dtype)
        v, x = z[..., 0], z[..., 1:]
        w = v * inv_s
        h = 0.5 * v
        e = torch.exp(-h)
        r = x * e[..., None]
        rr = r * r
        lp = (_sum64(-0.5 * rr - h[..., None])
              + (-0.5 * (w * w)).double()).to(z.dtype)
        g_v = (_sum64(0.5 * rr - 0.5) + (-(w * inv_s)).double()).to(z.dtype)
        return lp, torch.cat([g_v[..., None], -(r * e[..., None])], dim=-1)

    def _params(self):
        return torch.tensor([1.0 / self.v_scale], dtype=torch.float64), None


class NeuTraLogJoint(BuiltinDensity):
    """A built-in pulled back through a RealNVP affine-coupling flow ``f``
    (``zhusuan_tpu_torch.transform.affine_coupling_flow``):
    ``log p_base(f(y)) + log|det J_f(y)|``, the NeuTra-lifted density of
    :func:`~zhusuan_tpu_torch.mcmc.neutra_log_joint`.

    Coupling ``i`` conditions one half of the row on the other (even ``i``
    the first ``dim // 2`` elements) through ``h = relu(c W1 + b1)``,
    ``(shift, raw) = h W2 + b2``, ``ls = 2 tanh(raw / 2)``, and moves the
    other half to ``a e^ls + shift``; the log-det is the sum of every
    ``ls``. The gradient is written out backward through the couplings
    (not autograd). Each hidden unit is one lane of the kernel's warp, so
    the hidden width is padded with zeros to 32: ``c W1`` adds its terms in
    order, ``h W2`` and the conditioning half's gradient are butterfly sums
    over the 32 units, ``(d/dh)_u = sum_o d/dout_o W2[u, o]`` adds in
    order.

    :param base: a :class:`NealFunnelLogJoint`,
        :class:`DiagonalGaussianLogJoint` or
        :class:`EquicorrelatedGaussianLogJoint` over the latent.
    :param params: the flow's ``[{"w1", "b1", "w2", "b2"}]`` (e.g.
        :attr:`~zhusuan_tpu_torch.mcmc.NeuTraResult.params`); copied.
    """

    #: The kernel's limits: the row and the hidden width within a warp.
    MAX_DIM, MAX_HIDDEN = 32, 32

    kernel_id = 10

    def __init__(self, base: BuiltinDensity, params):
        parts = (NealFunnelLogJoint, DiagonalGaussianLogJoint,
                 EquicorrelatedGaussianLogJoint)
        if not isinstance(base, parts):
            raise TypeError("the base must be one of {}; got {!r}.".format(
                [c.__name__ for c in parts], type(base)))
        d = base.dim
        if d < 2:
            raise ValueError("couplings need dim >= 2; got {}.".format(d))
        super().__init__(base.name, d)
        self.base = base
        self.d1 = d // 2
        flows = []
        for i, p in enumerate(params):
            n_in, n_out = self.halves(i)
            w1, b1, w2, b2 = (_host64(p[k]) for k in ("w1", "b1", "w2", "b2"))
            hidden = w1.shape[-1]
            if (tuple(w1.shape) != (n_in, hidden) or tuple(b1.shape)
                    != (hidden,) or tuple(w2.shape) != (hidden, 2 * n_out)
                    or tuple(b2.shape) != (2 * n_out,)):
                raise ValueError(
                    "coupling {} does not fit dim {}: w1 {}, b1 {}, w2 {}, "
                    "b2 {}.".format(i, d, tuple(w1.shape), tuple(b1.shape),
                                    tuple(w2.shape), tuple(b2.shape)))
            flows.append((w1, b1, w2, b2))
        if not flows:
            raise ValueError("the flow needs at least one coupling.")
        self.hidden = flows[0][0].shape[-1]
        if any(f[0].shape[-1] != self.hidden for f in flows):
            raise ValueError("every coupling must have one hidden width.")
        self.flows = flows
        self._couplings = {}

    def halves(self, i):
        """``(n_in, n_out)`` of coupling ``i``."""
        d1, d2 = self.d1, self.dim - self.d1
        return (d1, d2) if i % 2 == 0 else (d2, d1)

    def _slices(self, i):
        """``(conditioning, active)`` slices of coupling ``i``."""
        lo, hi = slice(0, self.d1), slice(self.d1, self.dim)
        return (lo, hi) if i % 2 == 0 else (hi, lo)

    def kernel_ineligible(self):
        if self.dim > self.MAX_DIM or self.hidden > self.MAX_HIDDEN:
            return ("the NeuTra density takes dim <= {} and hidden <= {}; "
                    "got {} and {}".format(self.MAX_DIM, self.MAX_HIDDEN,
                                           self.dim, self.hidden))
        return None

    def _padded(self):
        """Each coupling's ``(W1 [n_in, 32], b1 [32], W2^T [2 n_out, 32],
        b2 [2 n_out])`` in float64, the hidden width padded with zeros (to
        a power of two past 32, where the kernel does not take it)."""
        width = max(self.MAX_HIDDEN, 1 << (self.hidden - 1).bit_length())
        pad = width - self.hidden
        out = []
        for w1, b1, w2, b2 in self.flows:
            out.append((torch.nn.functional.pad(w1, (0, pad)),
                        torch.nn.functional.pad(b1, (0, pad)),
                        torch.nn.functional.pad(w2.T, (0, pad)), b2))
        return out

    def couplings(self, dtype, device):
        """:meth:`_padded` in ``dtype`` on ``device`` (cached)."""
        key = (str(device), dtype)
        if key not in self._couplings:
            self._couplings[key] = [
                tuple(v.to(device=device, dtype=dtype) for v in c)
                for c in self._padded()]
        return self._couplings[key]

    def log_prob(self, y):
        return _written_out(self, y)

    @staticmethod
    def _net(c, w1, b1, w2t, b2):
        pre = c[..., 0:1] * w1[0]
        for a in range(1, c.shape[-1]):
            pre = pre + c[..., a:a + 1] * w1[a]
        pre = pre + b1
        h = torch.where(pre > 0, pre, torch.zeros_like(pre))
        return pre, _butterfly_sum(h[..., None, :] * w2t) + b2

    def value_and_grad(self, y):
        layers = self.couplings(y.dtype, y.device)
        z, saved, logdet = y, [], []
        for i, (w1, b1, w2t, b2) in enumerate(layers):
            cs, as_ = self._slices(i)
            n_out = self.halves(i)[1]
            c, a = z[..., cs], z[..., as_]
            pre, out = self._net(c, w1, b1, w2t, b2)
            t = torch.tanh(out[..., n_out:] * 0.5)
            ls = 2.0 * t
            e = torch.exp(ls)
            new = a * e + out[..., :n_out]
            saved.append((c, a, pre, t, e))
            logdet.append(ls)
            z = torch.cat([c, new] if i % 2 == 0 else [new, c], dim=-1)
        v, g = self.base.value_and_grad(z)
        lp = (v.double() + _sum64(torch.cat(logdet, -1))).to(y.dtype)
        for i in range(len(layers) - 1, -1, -1):
            w1, _, w2t, _ = layers[i]
            cs, as_ = self._slices(i)
            c, a, pre, t, e = saved[i]
            g_new = g[..., as_]
            g_ls = (g_new * a) * e + 1.0
            g_out = torch.cat([g_new, g_ls * (1.0 - t * t)], dim=-1)
            g_h = g_out[..., 0:1] * w2t[0]
            for o in range(1, g_out.shape[-1]):
                g_h = g_h + g_out[..., o:o + 1] * w2t[o]
            g_pre = torch.where(pre > 0, g_h, torch.zeros_like(g_h))
            g_c = g[..., cs] + _butterfly_sum(g_pre[..., None, :] * w1)
            g_a = g_new * e
            g = torch.cat([g_c, g_a] if i % 2 == 0 else [g_a, g_c], dim=-1)
        return lp, g

    def _params(self):
        return self.base._params()

    def aux_params(self):
        """The packed couplings (:meth:`_padded`, each flattened in order)
        and ``(n_couplings, hidden)``."""
        flat = torch.cat([v.reshape(-1) for c in self._padded() for v in c])
        return flat, torch.tensor([len(self.flows), self.hidden],
                                  dtype=torch.float64)


class GaussianLinearRegressionLogJoint(BuiltinDensity):
    """The Bayesian linear regression ``w ~ N(0, prior_std^2 I)``,
    ``y_i ~ N(x_i^T w, noise_std^2)`` over the latent ``w [dim]``, with
    its data: ``examples/model_comparison/loo_compare.py``'s model,
    normalising constants included, so it equals the model's log joint.

    Data table ``[n, dim + 1]``: ``x_i`` and ``y_i``; constants ``(dim,
    1 / noise_std, 1 / prior_std, C)``.

    :param name: the latent's name.
    :param x: ``[n, dim]`` design matrix.
    :param y: ``[n]`` responses.
    """

    #: The kernel's limit: the row on the first two lanes of the chain.
    MAX_DIM = 8

    kernel_id = 11

    def __init__(self, name: str, x, y, prior_std: float = 1.0,
                 noise_std: float = 1.0):
        x, y = _host64(x), _host64(y)
        if x.ndim != 2 or y.shape != x.shape[:1] or x.shape[0] < 1:
            raise ValueError("x must be [n, dim] and y [n]; got {} and "
                             "{}.".format(tuple(x.shape), tuple(y.shape)))
        prior_std, noise_std = float(prior_std), float(noise_std)
        if not (prior_std > 0.0 and noise_std > 0.0):
            raise ValueError("the standard deviations must be positive.")
        super().__init__(name, x.shape[1])
        self.x, self.y = x, y
        self.prior_std, self.noise_std = prior_std, noise_std
        n, d = x.shape
        self.const = (-0.5 * (n + d) * math.log(2.0 * math.pi)
                      - d * math.log(prior_std) - n * math.log(noise_std))

    def kernel_ineligible(self):
        if self.dim > self.MAX_DIM:
            return "the regression takes dim <= {}; got {}".format(
                self.MAX_DIM, self.dim)
        return None

    def _params(self):
        return (torch.cat([self.x, self.y[:, None]], -1),
                torch.tensor([self.dim, 1.0 / self.noise_std,
                              1.0 / self.prior_std, self.const],
                             dtype=torch.float64))

    def log_prob(self, w):
        return _written_out(self, w)

    def value_and_grad(self, w):
        table, (_, inv_n, inv_p, const) = self._table(w.dtype, w.device)
        d = self.dim
        xt, yv = table[:, :d], table[:, d]
        eta = w[..., 0, None] * xt[:, 0]
        for j in range(1, d):
            eta = eta + w[..., j, None] * xt[:, j]
        z = (yv - eta) * inv_n
        ws = w * inv_p
        lp = (_sum64(-0.5 * (z * z)) + _sum64(-0.5 * (ws * ws))
              + const).to(w.dtype)
        g = (_x_dot64(xt, z * inv_n) + (-(ws * inv_p)).double()).to(w.dtype)
        return lp, g


class PoissonChangepointLogJoint(BuiltinDensity):
    """The change-point posterior of ``examples/state_space/
    changepoint.py`` over ``{"tau", "log_lam"}``: ``log_lam_k ~ N(0,
    prior_std^2)`` (without constants), ``y_t ~ Poisson(exp(log_lam_0))``
    for ``t < tau`` and ``Poisson(exp(log_lam_1))`` after (without
    ``log y_t!``). ``log_lam [2]`` is the latent; ``tau [1]`` is read per
    chain (:attr:`chain_observed`): a Gibbs sweep's HMC block gets it as an
    observation, its discrete block scores candidate values of it.

    Data table ``[T, 1]``: ``y_t``; constants ``(T, 1 / prior_std)``.

    :param y: ``[T]`` counts.
    """

    kernel_id = 12
    chain_observed = ("tau",)

    def __init__(self, y, prior_std: float = 2.0):
        y = _host64(y)
        if y.ndim != 1 or y.shape[0] < 1:
            raise ValueError("y must be [T]; got {}.".format(tuple(y.shape)))
        prior_std = float(prior_std)
        if not prior_std > 0.0:
            raise ValueError("prior_std must be positive.")
        super().__init__("log_lam", 2)
        self.y, self.prior_std = y, prior_std

    def _params(self):
        return (self.y[:, None],
                torch.tensor([self.y.shape[0], 1.0 / self.prior_std],
                             dtype=torch.float64))

    def __call__(self, obs):
        return self.log_prob(torch.as_tensor(obs["log_lam"]),
                             torch.as_tensor(obs["tau"])[..., 0])

    def log_prob(self, log_lam, tau):
        """At ``log_lam [..., 2]`` and the change points ``tau [...]``."""
        return _written_out(self, log_lam, tau)

    def value_and_grad(self, log_lam, tau):
        table, (_, inv_p) = self._table(log_lam.dtype, log_lam.device)
        yv = table[:, 0]
        grid = torch.arange(yv.shape[0], dtype=log_lam.dtype,
                            device=log_lam.device)
        l0, l1 = log_lam[..., 0:1], log_lam[..., 1:2]
        before = grid < tau.to(log_lam.dtype)[..., None]
        lr = torch.where(before, l0, l1)
        e = torch.where(before, torch.exp(l0), torch.exp(l1))
        d_row = yv - e
        zero = torch.zeros_like(d_row)
        lh = log_lam * inv_p
        lp = (_sum64(yv * lr - e) + _sum64(-0.5 * (lh * lh))).to(
            log_lam.dtype)
        prior_g = (-(lh * inv_p)).double()
        g0 = _sum64(torch.where(before, d_row, zero)) + prior_g[..., 0]
        g1 = _sum64(torch.where(before, zero, d_row)) + prior_g[..., 1]
        return lp, torch.stack([g0, g1], dim=-1).to(log_lam.dtype)
