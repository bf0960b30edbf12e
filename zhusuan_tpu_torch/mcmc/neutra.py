"""Neural-transport (NeuTra) preconditioning for MCMC (port of
``zhusuan_tpu/mcmc/neutra.py``).

A RealNVP coupling flow ``x = f(y)`` is fitted to the posterior by SGVB
(Hoffman et al. 2019, "NeuTra-lizing Bad Geometry in Hamiltonian Monte
Carlo Using Neural Transport", arXiv:1903.03704); a sampler then runs in
the flow's latent coordinates ``y`` under the pullback density

    log p_lat(y) = log p(f(y)) + log|det J_f(y)|,

which the fitted flow has bent toward a standard normal (funnels and
bananas that defeat a constant mass matrix).

The fit is a Python loop of ``torch.optim.Adam`` steps (the JAX package's
is one ``lax.scan`` of ``optax.adam``) with the port's own
:func:`~zhusuan_tpu_torch.variational.advi.cosine_decay_schedule` (to 10%)
set as the learning rate before each step; the losses go into a device
vector that the caller reads once. Lifting a built-in (Neal's funnel, a
diagonal or equicorrelated Gaussian) through a flow that fits the HMC
kernel's limits gives the built-in
:class:`~zhusuan_tpu_torch.ops.densities.NeuTraLogJoint`, which the HMC
transition's kernel evaluates on the card (the JAX package traces the
lifted closure into its Pallas kernel); lifting any other log-joint gives a
closure, on which HMC runs its plain transition.

Typical use::

    res = fit_neutra(log_joint, "z", d, torch.Generator("cuda"))
    lat_lj, to_lat, from_lat = neutra_log_joint(log_joint, "z", res.params)
    state = hmc.init({"z": torch.zeros(n_chains, d, device="cuda")},
                     n_chain_dims=1)
    state, out = hmc.run(lat_lj, {}, state, key, 1000, n_adapt=500)
    x = from_lat(out["samples"]["z"])
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
    NealFunnelLogJoint,
    NeuTraLogJoint,
)
from zhusuan_tpu_torch.transform import (
    affine_coupling_flow,
    init_affine_coupling,
)
from zhusuan_tpu_torch.variational.advi import cosine_decay_schedule

__all__ = ["fit_neutra", "neutra_log_joint", "NeuTraResult"]


class NeuTraResult(NamedTuple):
    """Output of :func:`fit_neutra`: the fitted coupling-flow parameters
    and the negative ELBO of every step."""

    params: list
    losses: torch.Tensor  # [n_iters] negative ELBO per step, on the device


def fit_neutra(log_joint, name: str, d: int, generator=None,
               n_flows: int = 6, hidden: int = 32, n_iters: int = 2000,
               n_particles: int = 64, learning_rate: float = 1e-2,
               dtype=torch.float32, *, init_params=None,
               noise=None) -> NeuTraResult:
    """Fit a RealNVP transport ``x = f(y)`` to the posterior of latent
    ``name`` by SGVB: the flow pushes ``N(0, I_d)`` onto the posterior and
    the loss is the negative ELBO ``E_y[log q(f(y)) - log p(f(y))]`` with
    the flow density from the accumulated log-det.

    :param log_joint: ``log_joint(obs_dict)`` or a ``MetaBayesianNet``
        (latents other than ``name`` observed or absent).
    :param name: the transported latent (data shape ``[d]``).
    :param d: the latent dimension (>= 2: couplings split the axis).
    :param generator: a ``torch.Generator`` on the device of the fit: the
        flow's initial weights and each step's ``[n_particles, d]`` base
        normals come from it.
    :param n_flows, hidden: stacked couplings and their MLP width.
    :param n_iters: optimization steps; :param n_particles: ELBO particles
        a step.
    :param learning_rate: Adam's, cosine-decayed to 10% over ``n_iters``.
    :param init_params: initial flow parameters in place of
        ``init_affine_coupling(generator, ...)`` (e.g. the JAX package's,
        through :func:`~zhusuan_tpu_torch.transform.params_from_numpy`);
        they are copied, not trained in place.
    :param noise: ``[n_iters, n_particles, d]`` base normals in place of
        the generator's (a testing hook).
    :return: :class:`NeuTraResult`.
    """
    if int(d) < 2:
        raise ValueError(
            "NeuTra couplings need d >= 2 (got d={}); for 1-D latents "
            "use whiten_log_joint or a bijector.".format(d))
    n_iters, n_particles, d = int(n_iters), int(n_particles), int(d)
    lj = make_log_joint_fn(log_joint, {})
    if init_params is None:
        if generator is None:
            raise ValueError("fit_neutra needs a torch.Generator or "
                             "init_params.")
        params = init_affine_coupling(generator, int(n_flows), d,
                                      hidden=int(hidden), dtype=dtype)
    else:
        params = [{k: v.detach().clone() for k, v in p.items()}
                  for p in init_params]
    leaves = [v.requires_grad_(True) for p in params for v in p.values()]
    device, dtype = leaves[0].device, leaves[0].dtype
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
        if tuple(noise.shape) != (n_iters, n_particles, d):
            raise ValueError("noise must have shape {}; got {}.".format(
                (n_iters, n_particles, d), tuple(noise.shape)))
    elif generator is None:
        raise ValueError("fit_neutra needs a torch.Generator or noise.")
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    schedule = cosine_decay_schedule(learning_rate, max(n_iters, 1), 0.1)
    half_log_2pi = float(0.5 * math.log(2.0 * math.pi))
    losses = torch.empty((n_iters,), dtype=dtype, device=device)
    for i in range(n_iters):
        z = noise[i] if noise is not None else torch.randn(
            (n_particles, d), generator=generator, dtype=dtype,
            device=device)
        base_lp = torch.sum(-0.5 * z * z - half_log_2pi, dim=-1)
        x, log_q = affine_coupling_flow(z, base_lp, params)
        loss = torch.mean(log_q - lj({name: x}))
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    for v in leaves:
        v.requires_grad_(False)
    return NeuTraResult(params=params, losses=losses)


def neutra_log_joint(log_joint, name: str, params):
    """The NeuTra-lifted density and the coordinate maps for latent
    ``name``.

    In the transported coordinates ``y`` the density is
    ``log p(f(y)) + log|det J_f(y)|``; the Jacobian term depends on the
    position and stays in the density.

    :param log_joint: the original ``log_joint(obs_dict)`` or a
        ``MetaBayesianNet``.
    :param name: the transported latent (data shape ``[d]``).
    :param params: fitted coupling parameters (:attr:`NeuTraResult.params`).
    :return: ``(latent_log_joint, to_latent, from_latent)``: the lifted
        density over ``{name: y}`` (a :class:`~zhusuan_tpu_torch.ops.
        densities.NeuTraLogJoint` when ``log_joint`` is a built-in funnel
        or Gaussian over ``name`` and the flow fits the kernel, else a
        closure) and the maps ``x -> y`` (the exact coupling inverse) and
        ``y -> x`` on ``[..., d]`` tensors.
    """
    lifted = None
    if (isinstance(log_joint, (NealFunnelLogJoint, DiagonalGaussianLogJoint,
                               EquicorrelatedGaussianLogJoint))
            and log_joint.name == name):
        lifted = NeuTraLogJoint(log_joint, params)
        if lifted.kernel_ineligible() is not None:
            lifted = None
    lj = make_log_joint_fn(log_joint, {})

    def _flow(arr, inverse):
        arr = torch.as_tensor(arr)
        flat = arr.reshape((-1, arr.shape[-1]))
        zeros = torch.zeros(flat.shape[:-1], dtype=flat.dtype,
                            device=flat.device)
        out, _ = affine_coupling_flow(flat, zeros, params, inverse=inverse)
        return out.reshape(arr.shape)

    def latent_log_joint(obs):
        y = torch.as_tensor(obs[name])
        squeeze = y.ndim == 1
        if squeeze:
            y = y[None]
        zeros = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
        x, neg_log_det = affine_coupling_flow(y, zeros, params)
        # The forward pass returns base_lp - log|det J|: with base_lp = 0
        # the second output is -log|det J_f(y)|.
        out = lj({name: x}) - neg_log_det
        return out[0] if squeeze else out

    def from_latent(y):
        return _flow(y, inverse=False)

    def to_latent(x):
        return _flow(x, inverse=True)

    return lifted or latent_log_joint, to_latent, from_latent
