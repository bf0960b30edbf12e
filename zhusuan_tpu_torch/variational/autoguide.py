"""Automatic variational guides (ADVI): mean-field and full-rank.

Port of ``zhusuan_tpu/variational/autoguide.py``. Automatic differentiation
variational inference (Kucukelbir et al. 2017) DERIVES the family from the
model: each free latent is mapped to an unconstrained space by a
support-matching bijector (positive -> softplus, interval -> sigmoid,
simplex -> stick-breaking, correlation Cholesky -> canonical partial
correlations; :mod:`zhusuan_tpu_torch.bijectors`), a Gaussian is fit there,
and samples are pushed back through the bijector with the log-det
correction. Vector bijectors change the trailing shape, so the guide's
parameter shapes come from ``bijector.unconstrained_shape`` (a K-simplex
latent gets K-1 free coordinates).

A guide is a pure function of an explicit parameter dict:
``guide.sample(params, key, n_samples)``; the parameters are plain tensors
that drop into any ``torch.optim`` optimizer. The full-rank guide samples
ONE ``[D]`` Gaussian through its Cholesky factor and attributes EXACT
per-latent conditional densities by the factor's autoregressive structure:
``log q(z_i | z_{<i})`` is the standard-normal density of the block's own
``eps`` minus its block's log-diagonal, so the per-name ``(samples,
log_prob)`` pairs sum to the joint log density exactly.

Divergences from the JAX package:

- ``key`` is a ``torch.Generator`` on the parameters' device, or a Philox
  key ``(k0, k1)`` from which one is seeded; the latents draw from it in
  sorted-name order (JAX splits its key per name). ``eps=`` replaces the
  draws (a dict per name for the mean-field guide, one ``[n, D]`` tensor for
  the full-rank one): a testing hook, so both packages can be fed the same
  numbers.
- The model may be a built-in density (:class:`~zhusuan_tpu_torch.ops.
  densities.BuiltinDensity`) where JAX insists on a ``MetaBayesianNet``: the
  guide then has one latent, ``density.name``, of shape ``[density.dim]``,
  float32, with the identity bijector, and needs no probe of the model.
  This is the form the whole-fit CUDA trainer takes
  (:func:`zhusuan_tpu_torch.variational.advi`), which cannot trace an
  arbitrary model as the TPU kernel does.
- ``_default_bijector`` looks every distribution class up by name, so the
  classes the port does not have yet are skipped, not stubbed.

Typical use::

    guide = MeanFieldGuide(model(), observed={"x": x})
    params = guide.init_params()       # then requires_grad_() each leaf
    lat = guide.latent(params, generator, n_samples=64)
    loss = elbo(model(), {"x": x}, latent=lat, axis=0).sgvb()
    # ... backward, optimizer step; then:
    post = guide.sample_posterior(params, generator, n_samples=1000)

Guides are reparameterized by construction: use the ``sgvb`` estimator.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from zhusuan_tpu_torch import bijectors as bij
from zhusuan_tpu_torch import distributions as dist_mod
from zhusuan_tpu_torch.framework.bn import StochasticTensor
from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet
from zhusuan_tpu_torch.ops._random import iteration_generator
from zhusuan_tpu_torch.ops.densities import BuiltinDensity
from zhusuan_tpu_torch.utils import tree_map

__all__ = ["MeanFieldGuide", "FullRankGuide", "params_from_numpy",
           "params_to_numpy"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class _Identity(bij.Bijector):
    def forward(self, y):
        return y

    def inverse(self, x):
        return x

    def forward_log_det(self, y):
        return torch.zeros_like(y)


def _isinstance_of(d, *names) -> bool:
    """Whether ``d`` is an instance of one of the distribution classes of
    these names that the port has (a missing class matches nothing)."""
    classes = tuple(c for c in (getattr(dist_mod, n, None) for n in names)
                    if c is not None)
    return bool(classes) and isinstance(d, classes)


def _default_bijector(d):
    """Support-matching bijector for a distribution instance, or raise
    for supports ADVI cannot handle generically."""
    if _isinstance_of(d, "HalfCauchy", "LogNormal", "Exponential", "Gamma",
                      "InverseGamma", "FoldNormal"):
        return bij.Softplus()
    if _isinstance_of(d, "Beta", "BinConcrete"):
        return bij.Sigmoid()
    if _isinstance_of(d, "Uniform"):
        lo, hi = d.minval, d.maxval
        if lo.ndim == 0 and hi.ndim == 0:
            return bij.Sigmoid(float(lo), float(hi))
        raise ValueError(
            "Uniform latent with non-scalar bounds needs an explicit "
            "bijector (pass bijectors={name: ...}).")
    if _isinstance_of(d, "Dirichlet"):
        return bij.StickBreaking()
    if _isinstance_of(d, "LKJCholesky"):
        return bij.CorrelationCholesky()
    if _isinstance_of(d, "Wishart"):
        raise ValueError(
            "Latent '{}' is a PD-matrix support with no generic ADVI "
            "bijector; pass an explicit bijector for it, fix it via "
            "`observed`, or marginalize it.".format(type(d).__name__))
    return _Identity()


def _generator(key, device) -> torch.Generator:
    """``key`` as a ``torch.Generator``: itself, or one seeded from the
    Philox key ``(k0, k1)`` on ``device``."""
    if isinstance(key, torch.Generator):
        return key
    if key is None:
        raise ValueError("Sampling a guide needs a torch.Generator, a key "
                         "(k0, k1) or eps.")
    k0, k1 = key
    return iteration_generator((int(k0), int(k1)), 0, device)


class _AutoGuideBase:
    """Shared model tracing: find the free latents, their shapes/dtypes,
    and support bijectors.

    :param meta_bn: the model: a :class:`MetaBayesianNet`, or a built-in
        density (one latent of shape ``[dim]``).
    :param observed: observation dict (defines the free latents).
    :param bijectors: optional ``{name: Bijector}`` overrides.
    :param device: where a built-in density's guide keeps its parameters
        (None: ``cuda:0``); a ``MetaBayesianNet``'s guide lives where the
        model's nodes do.
    """

    def __init__(self, meta_bn, observed: Optional[Dict] = None,
                 bijectors: Optional[Dict] = None, device=None):
        observed = dict(observed or {})
        overrides = dict(bijectors or {})
        self._names, self._shapes, self._dtypes, self._bijectors = (
            [], {}, {}, {})
        if isinstance(meta_bn, BuiltinDensity):
            self._device = (torch.device("cuda", 0) if device is None
                            else torch.device(device))
            if meta_bn.name not in observed:
                name = meta_bn.name
                self._names.append(name)
                b = overrides.get(name, _Identity())
                self._bijectors[name] = b
                self._shapes[name] = tuple(
                    b.unconstrained_shape((meta_bn.dim,)))
                self._dtypes[name] = torch.float32
        elif isinstance(meta_bn, MetaBayesianNet):
            # One eager forward sample exposes each node's distribution
            # instance and (chainless) shape.
            probe = meta_bn.observe(key=0, **observed)
            self._device = None
            for name, node in probe.nodes.items():
                if (not isinstance(node, StochasticTensor)
                        or node.is_observed):
                    continue
                d = node.dist
                if not d.dtype.is_floating_point:
                    raise ValueError(
                        "Latent '{}' is discrete ({}); ADVI requires "
                        "continuous free latents: observe it, enumerate it "
                        "out, or use a score-function objective with a "
                        "hand-written variational net.".format(name, d.dtype))
                self._names.append(name)
                b = (overrides[name] if name in overrides
                     else _default_bijector(d))
                self._bijectors[name] = b
                # The guide lives in the UNCONSTRAINED space; vector
                # bijectors (StickBreaking, CorrelationCholesky) change the
                # trailing shape, so parameter shapes come from the bijector.
                self._shapes[name] = tuple(
                    b.unconstrained_shape(tuple(node.tensor.shape)))
                self._dtypes[name] = node.tensor.dtype
                if self._device is None:
                    self._device = node.tensor.device
        else:
            raise TypeError(
                "meta_bn must be a MetaBayesianNet (decorate the model "
                "builder with @meta_bayesian_net() and CALL it) or a "
                "built-in density, got {!r}.".format(type(meta_bn)))
        if not self._names:
            raise ValueError(
                "The model has no free latents under the given "
                "`observed`.")
        self._names = sorted(self._names)
        self._sizes = {
            n: int(np.prod(self._shapes[n], dtype=np.int64))
            for n in self._names
        }
        self._dim = sum(self._sizes.values())
        self._dtype = functools.reduce(
            torch.promote_types, [self._dtypes[n] for n in self._names])

    # -- public metadata ----------------------------------------------- #
    @property
    def latent_names(self):
        """Sorted names of the free latents the guide covers."""
        return list(self._names)

    @property
    def bijectors(self):
        """The support bijector per latent (after overrides)."""
        return dict(self._bijectors)

    @property
    def device(self) -> torch.device:
        """Where :meth:`init_params` puts the parameters."""
        return self._device

    # -- shared pieces -------------------------------------------------- #
    def _split(self, flat, lead=()):
        """A flat ``lead + [D]`` tensor as ``{name: lead + shape}`` in
        sorted-name block order."""
        out, off = {}, 0
        for n in self._names:
            out[n] = flat[..., off:off + self._sizes[n]].reshape(
                tuple(lead) + self._shapes[n])
            off += self._sizes[n]
        return out

    def _constrain(self, z_u: Dict, lead_ndim: int):
        """Push unconstrained samples through the bijectors; return
        ``(samples, per-name -log|det J| summed over data axes)``."""
        samples, neg_ld = {}, {}
        for n in self._names:
            b = self._bijectors[n]
            y = z_u[n]
            samples[n] = b.forward(y)
            ld = b.forward_log_det(y)
            axes = tuple(range(lead_ndim, ld.ndim))
            neg_ld[n] = -torch.sum(ld, dim=axes) if axes else -ld
        return samples, neg_ld

    def latent(self, params, key, n_samples: Optional[int] = None, eps=None):
        """The dict for ``elbo(..., latent=guide.latent(...))``: per-name
        ``(samples, log_prob)`` pairs whose log-probs sum to the guide's
        joint log density."""
        samples, log_probs = self.sample(params, key, n_samples, eps=eps)
        return {n: (samples[n], log_probs[n]) for n in self._names}

    def sample_posterior(self, params, key, n_samples: int, eps=None):
        """Constrained posterior-approximation draws only."""
        return self.sample(params, key, n_samples, eps=eps)[0]


class MeanFieldGuide(_AutoGuideBase):
    """Factorized Gaussian in the unconstrained space (ADVI mean-field).

    Parameters: ``{"loc": {name: tensor}, "log_scale": {name: tensor}}`` in
    the unconstrained space, one entry per latent, shapes matching the
    latent. ``init_scale`` follows the ADVI default of a tight initial
    fit (exp(-2.3) ~= 0.1).
    """

    def __init__(self, meta_bn, observed=None, bijectors=None,
                 init_scale: float = 0.1, device=None):
        super().__init__(meta_bn, observed, bijectors, device)
        if not float(init_scale) > 0.0:
            raise ValueError("init_scale must be positive.")
        self._init_log_scale = float(np.log(init_scale))

    def init_params(self):
        return {
            "loc": {
                n: torch.zeros(self._shapes[n], dtype=self._dtypes[n],
                               device=self._device)
                for n in self._names
            },
            "log_scale": {
                n: torch.full(self._shapes[n], self._init_log_scale,
                              dtype=self._dtypes[n], device=self._device)
                for n in self._names
            },
        }

    def sample(self, params, key, n_samples: Optional[int] = None, eps=None):
        """Draw from the guide.

        :param key: a ``torch.Generator`` on the parameters' device or a
            key ``(k0, k1)``; unused when ``eps`` is given.
        :param eps: optional ``{name: standard normals of shape
            [n_samples] + the latent's unconstrained shape}`` replacing the
            draws (testing hook).
        :return: ``(samples, log_probs)``: constrained samples and the
            per-name log densities (data axes reduced), each with a
            leading ``[n_samples]`` axis unless ``n_samples`` is None.
        """
        lead = () if n_samples is None else (int(n_samples),)
        gen = None
        z_u, log_q = {}, {}
        for n in self._names:
            loc, ls = params["loc"][n], params["log_scale"][n]
            shape = lead + self._shapes[n]
            if eps is not None:
                e = torch.as_tensor(eps[n], dtype=loc.dtype,
                                    device=loc.device)
                if tuple(e.shape) != shape:
                    raise ValueError(
                        "eps[{!r}] must have shape {}; got {}.".format(
                            n, shape, tuple(e.shape)))
            else:
                if gen is None:
                    gen = _generator(key, loc.device)
                e = torch.randn(shape, generator=gen, dtype=loc.dtype,
                                device=loc.device)
            z_u[n] = loc + torch.exp(ls) * e
            per = -0.5 * e * e - _HALF_LOG_2PI - ls
            axes = tuple(range(len(lead), per.ndim))
            log_q[n] = torch.sum(per, dim=axes) if axes else per
        samples, neg_ld = self._constrain(z_u, len(lead))
        return samples, {
            n: log_q[n] + neg_ld[n] for n in self._names
        }

    def median(self, params):
        """The guide's (constrained) componentwise median: the
        bijector-pushed location; a cheap point estimate."""
        return {
            n: self._bijectors[n].forward(params["loc"][n])
            for n in self._names
        }


class FullRankGuide(_AutoGuideBase):
    """Joint Gaussian over ALL unconstrained latents (ADVI full-rank):
    one ``[D]`` location and a Cholesky factor, sampled with a single
    matmul. Captures cross-latent posterior correlations the mean-field
    family cannot.

    Parameters: ``{"loc": [D], "chol_raw": [D, D]}``; ``chol_raw``'s
    strict lower triangle is used as it is and its diagonal is passed
    through softplus (+1e-6) for positivity; ``init_params`` starts at
    ``diag ~= init_scale``.
    """

    def __init__(self, meta_bn, observed=None, bijectors=None,
                 init_scale: float = 0.1, device=None):
        super().__init__(meta_bn, observed, bijectors, device)
        if not float(init_scale) > 0.0:
            raise ValueError("init_scale must be positive.")
        self._init_scale = float(init_scale)
        # Block layout in the flat vector, sorted-name order.
        self._starts, s = {}, 0
        for n in self._names:
            self._starts[n] = s
            s += self._sizes[n]

    def init_params(self):
        # softplus(raw) = init_scale on the diagonal.
        raw_diag = float(np.log(np.expm1(self._init_scale)))
        return {
            "loc": torch.zeros((self._dim,), dtype=self._dtype,
                               device=self._device),
            "chol_raw": torch.eye(self._dim, dtype=self._dtype,
                                  device=self._device) * raw_diag,
        }

    def _chol(self, params):
        raw = params["chol_raw"]
        d = torch.diagonal(raw)
        diag = torch.logaddexp(d, torch.zeros_like(d)) + 1e-6
        return torch.tril(raw, -1) + torch.diag(diag), torch.log(diag)

    def sample(self, params, key, n_samples: Optional[int] = None, eps=None):
        """Draw from the guide; see :meth:`MeanFieldGuide.sample` (``eps``
        here is one ``[n_samples, D]`` tensor). Per-name log-probs are the
        EXACT autoregressive conditionals ``log q(z_i | z_{<i})`` of the
        joint Gaussian (sorted-name block order), so they sum to the joint
        log density."""
        lead = () if n_samples is None else (int(n_samples),)
        L, log_diag = self._chol(params)
        loc = params["loc"]
        shape = lead + (self._dim,)
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=loc.dtype, device=loc.device)
            if tuple(eps.shape) != shape:
                raise ValueError("eps must have shape {}; got {}.".format(
                    shape, tuple(eps.shape)))
        else:
            eps = torch.randn(shape, generator=_generator(key, loc.device),
                              dtype=loc.dtype, device=loc.device)
        flat = loc + eps @ L.T
        # log q(z_block | previous blocks) = sum over the block's coords
        # of [ log N(eps_c) - log L_cc ]  (Cholesky autoregression).
        per_coord = -0.5 * eps * eps - _HALF_LOG_2PI - log_diag
        z_u, log_q = {}, {}
        for n in self._names:
            s, e = self._starts[n], self._starts[n] + self._sizes[n]
            z_u[n] = flat[..., s:e].reshape(
                lead + self._shapes[n]).to(self._dtypes[n])
            log_q[n] = torch.sum(per_coord[..., s:e], dim=-1)
        samples, neg_ld = self._constrain(z_u, len(lead))
        return samples, {n: log_q[n] + neg_ld[n] for n in self._names}

    def median(self, params):
        """Bijector-pushed location (componentwise), unraveled per
        latent."""
        loc = params["loc"]
        out = {}
        for n in self._names:
            s, e = self._starts[n], self._starts[n] + self._sizes[n]
            out[n] = self._bijectors[n].forward(
                loc[s:e].reshape(self._shapes[n]).to(self._dtypes[n]))
        return out

    def covariance(self, params):
        """The guide's unconstrained-space covariance ``L @ L.T`` (for
        inspection / Laplace-style reuse)."""
        L, _ = self._chol(params)
        return L @ L.T


def params_from_numpy(guide, params, device=None, dtype=None):
    """The JAX guide's parameter pytree (``{"loc": {name: array},
    "log_scale": {...}}``, or ``{"loc", "chol_raw"}``) given as numpy arrays,
    as the port's tensors on ``device`` (None: the guide's), so that both
    packages start a fit from the same point. The names and the flat order
    (sorted names) are the same in both packages.

    :param dtype: optional dtype of every leaf (None: each array's own).
    """
    device = guide.device if device is None else torch.device(device)
    expected = guide.init_params()
    if set(params) != set(expected):
        raise ValueError("params has keys {}; the guide's are {}.".format(
            sorted(params), sorted(expected)))
    for k, sub in expected.items():
        if isinstance(sub, dict) and set(params[k]) != set(sub):
            raise ValueError("params[{!r}] has names {}; the guide's latents "
                             "are {}.".format(k, sorted(params[k]),
                                              sorted(sub)))
    return tree_map(lambda v: torch.as_tensor(
        np.asarray(v), dtype=dtype, device=device), params)


def params_to_numpy(params):
    """A guide's parameter dict as numpy arrays of the same structure."""
    return tree_map(lambda v: v.detach().cpu().numpy(), params)
