"""One-call ADVI: automatic guide + the whole optimisation.

Port of ``zhusuan_tpu/variational/advi.py``: packages the
:class:`~zhusuan_tpu_torch.variational.MeanFieldGuide` /
:class:`~zhusuan_tpu_torch.variational.FullRankGuide` workflow (derive the
family, initialise the parameters, run Adam on the ``sgvb`` loss) into one
call. Two execution paths:

- the whole fit as ONE launch of the hand-written CUDA trainer
  (:func:`zhusuan_tpu_torch.ops.fused_meanfield_advi`), when eligible;
- the plain loop: a Python loop over a step function (``guide.latent`` ->
  ``elbo(...).sgvb()`` -> backward -> ``torch.optim.Adam``, whose update is
  optax's), the counterpart of the JAX package's ``lax.scan`` program.

The JAX package's kernel traces an arbitrary model into its body; a CUDA
kernel cannot. So the kernel path takes a built-in density of
:data:`zhusuan_tpu_torch.ops.advi_step.DENSITIES` as the model (one latent,
identity bijector); with a ``MetaBayesianNet``, or any bijector other than
the identity, ``experimental_fused="auto"`` takes the plain loop and
``True`` raises with the reason.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from zhusuan_tpu_torch.ops._random import as_key, iteration_generator
from zhusuan_tpu_torch.variational.autoguide import (
    FullRankGuide,
    MeanFieldGuide,
    _Identity,
)
from zhusuan_tpu_torch.variational.exclusive_kl import elbo

__all__ = ["advi", "ADVIResult", "cosine_decay_schedule"]


class ADVIResult(NamedTuple):
    """Output of :func:`advi`: the fitted guide + parameters, plus the
    per-iteration negative-ELBO trace for convergence inspection.
    Draw posterior samples with
    ``result.guide.sample_posterior(result.params, key, n)``."""

    guide: object
    params: dict
    losses: torch.Tensor  # [n_iters] negative ELBO per step


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
    """``t -> init_value * ((1 - alpha) * 0.5 * (1 + cos(pi * min(t, T) /
    T)) + alpha)`` with ``T = decay_steps``: the formula of
    ``optax.cosine_decay_schedule``, as a plain Python callable."""
    if not decay_steps > 0:
        raise ValueError("decay_steps must be positive.")

    def schedule(t):
        frac = min(max(float(t), 0.0), decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _leaves(params):
    out = []
    for sub in params.values():
        out += list(sub.values()) if isinstance(sub, dict) else [sub]
    return out


def _fresh(params, requires_grad):
    """A detached copy of the parameter dict (the caller's tensors are
    never updated in place)."""
    def copy(v):
        return v.detach().clone().requires_grad_(requires_grad)

    return {k: ({n: copy(v) for n, v in sub.items()}
                if isinstance(sub, dict) else copy(sub))
            for k, sub in params.items()}


def advi(
    meta_bn,
    observed,
    key,
    guide="meanfield",
    n_iters: int = 2000,
    n_samples: int = 32,
    learning_rate: float = 1e-2,
    optimizer: Optional[Callable] = None,
    bijectors: Optional[dict] = None,
    init_params: Optional[dict] = None,
    lr_schedule: Optional[Callable] = None,
    experimental_fused="auto",
    noise=None,
    device=None,
) -> ADVIResult:
    """Fit an automatic Gaussian guide to the model's posterior by SGVB.

    :param meta_bn: the model: a ``MetaBayesianNet``, or a built-in density
        (:class:`~zhusuan_tpu_torch.ops.densities.BuiltinDensity`).
    :param observed: observation dict (defines the free latents).
    :param key: a Philox key ``(k0, k1)`` or a ``torch.Generator`` to draw
        one from; step ``t``'s draws depend only on the key and ``t``.
    :param guide: ``"meanfield"``, ``"fullrank"``, or an already-built
        guide instance (anything exposing ``init_params`` / ``latent``).
    :param n_iters: optimization steps.
    :param n_samples: ELBO particles per step.
    :param learning_rate: Adam step size with cosine decay to 10%
        (ignored when ``optimizer`` or ``lr_schedule`` is given).
    :param optimizer: optional callable from the list of parameter tensors
        to a ``torch.optim.Optimizer``, overriding the default Adam (and
        the schedule).
    :param bijectors: optional per-latent support bijector overrides,
        passed through to the guide constructor.
    :param init_params: optional initial guide parameters (same structure
        as ``guide.init_params()``) overriding the default init; they are
        copied, not updated in place.
    :param lr_schedule: optional Python callable ``step -> lr`` (e.g.
        :func:`cosine_decay_schedule`, or ``lambda t: 0.1``) replacing the
        default cosine decay; both execution paths use it through Adam.
    :param experimental_fused: ``"auto"`` (default) runs the ENTIRE fit as
        one launch of the CUDA trainer when eligible: a built-in density as
        the model, mean-field guide with identity bijectors, default Adam,
        float32, a size :func:`~zhusuan_tpu_torch.ops.advi_step.
        advi_step_supported` takes, parameters on a CUDA device; the
        gradients are those of the plain loop per sample, the random stream
        is not. ``True`` forces it (raises when ineligible; on CPU
        parameters it runs the trainer's plain version: test use only),
        ``False`` always uses the plain loop.
    :param noise: optional standard normals ``[n_iters, n_samples, D]``
        (``D``: the guide's flat width, sorted-name blocks) replacing the
        draws on either path (testing hook).
    :param device: where a built-in density's guide lives (None:
        ``cuda:0``); see the guides.
    :return: :class:`ADVIResult`.
    """
    if isinstance(guide, str):
        cls = {"meanfield": MeanFieldGuide, "fullrank": FullRankGuide}.get(
            guide.lower())
        if cls is None:
            raise ValueError(
                "guide must be 'meanfield', 'fullrank', or a guide "
                "instance; got {!r}.".format(guide))
        g = cls(meta_bn, observed=observed, bijectors=bijectors,
                device=device)
    else:
        g = guide

    n_iters, n_samples = int(n_iters), int(n_samples)
    if lr_schedule is None:
        lr_schedule = cosine_decay_schedule(learning_rate, max(n_iters, 1),
                                            0.1)
    key = None if noise is not None and key is None else as_key(key)
    if experimental_fused is not False and optimizer is None:
        fused = _maybe_fused_fit(
            g, meta_bn, observed, key, n_iters, n_samples, lr_schedule,
            init_params, force=(experimental_fused is True), noise=noise)
        if fused is not None:
            return fused
    elif experimental_fused is True:
        raise ValueError(
            "experimental_fused=True requires the default optimizer "
            "(the kernel replicates Adam + the learning-rate schedule); "
            "got a custom optimizer.")

    params = _fresh(g.init_params() if init_params is None else init_params,
                    True)
    leaves = _leaves(params)
    scheduled = optimizer is None
    opt = (torch.optim.Adam(leaves, lr=float(lr_schedule(0.0)))
           if scheduled else optimizer(leaves))
    dev = leaves[0].device
    losses = torch.empty((n_iters,), dtype=leaves[0].dtype, device=dev)
    for t in range(n_iters):
        if noise is not None:
            gen, eps = None, _guide_eps(g, noise[t])
        else:
            gen, eps = iteration_generator(key, t, dev), None
        if scheduled:
            for group in opt.param_groups:
                group["lr"] = float(lr_schedule(float(t)))
        opt.zero_grad(set_to_none=True)
        lat = g.latent(params, gen, n_samples=n_samples, eps=eps)
        loss = elbo(meta_bn, observed, latent=lat, axis=0).sgvb()
        loss.backward()
        opt.step()
        losses[t] = loss.detach()
    return ADVIResult(guide=g, params=_fresh(params, False), losses=losses)


def _guide_eps(g, flat):
    """One step's flat ``[n_samples, D]`` normals in the form the guide's
    ``eps=`` takes: a dict per name for the mean-field guide."""
    if isinstance(g, MeanFieldGuide):
        return g._split(flat, flat.shape[:-1])
    return flat


def _maybe_fused_fit(g, meta_bn, observed, key, n_iters, n_samples,
                     lr_schedule, init_params, force, noise=None):
    """Run the whole fit as one launch of the CUDA trainer when eligible
    (None when not and ``force`` is False; raises when not and ``force`` is
    True)."""
    from zhusuan_tpu_torch.ops.advi_step import (
        DENSITIES,
        advi_step_supported,
        fused_meanfield_advi,
    )

    def bail(reason):
        if force:
            raise ValueError(
                "experimental_fused=True but the fused ADVI kernel "
                "cannot run: " + reason)
        return None

    if not isinstance(g, MeanFieldGuide):
        return bail("only the mean-field guide has a fused trainer.")
    if not isinstance(meta_bn, DENSITIES):
        return bail(
            "the CUDA kernel evaluates only the built-in densities {} "
            "(it cannot trace a model as the TPU kernel does); {} takes "
            "the plain loop.".format([c.__name__ for c in DENSITIES],
                                     type(meta_bn).__name__))
    names = g.latent_names
    if names != [meta_bn.name] or g._dim != meta_bn.dim:
        return bail("the guide does not cover the density's one latent "
                    "'{}' of dim {}.".format(meta_bn.name, meta_bn.dim))
    if not isinstance(g.bijectors[meta_bn.name], _Identity):
        return bail("the kernel fits the density as it is: the latent's "
                    "bijector must be the identity, got {}.".format(
                        type(g.bijectors[meta_bn.name]).__name__))
    if g._dtype != torch.float32:
        return bail("the kernel is float32-only (guide dtype {})."
                    .format(g._dtype))
    dim = g._dim
    if not advi_step_supported(dim, n_samples, n_iters):
        return bail(
            "unsupported size (dim={}, n_samples={}, n_iters={}).".format(
                dim, n_samples, n_iters))
    params = g.init_params() if init_params is None else init_params
    name = meta_bn.name
    loc0 = params["loc"][name].detach().reshape(-1)
    ls0 = params["log_scale"][name].detach().reshape(-1)
    if loc0.dtype != torch.float32 or ls0.dtype != torch.float32:
        return bail("the kernel is float32-only (parameters {}).".format(
            loc0.dtype))
    if loc0.device.type != "cuda" and not force:
        return None  # the kernel runs on the card; its plain version is
        # for tests
    loc, ls, losses = fused_meanfield_advi(
        meta_bn, loc0, ls0, n_iters, n_samples, key, lr_schedule,
        noise=noise)
    shape = g._shapes[name]
    fitted = {"loc": {name: loc.reshape(shape)},
              "log_scale": {name: ls.reshape(shape)}}
    return ADVIResult(guide=g, params=fitted, losses=losses)
