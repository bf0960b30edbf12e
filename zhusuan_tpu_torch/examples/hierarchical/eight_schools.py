"""Eight schools: hierarchical partial pooling (Rubin 1981; BDA 5.5).

Port of ``examples/hierarchical/eight_schools.py``: school effects
``theta_j`` partially pooled through ``(mu, tau)``, a ``HalfCauchy(5)``
prior on ``tau``, ``tau`` sampled on its Softplus-unconstrained scale.

- :func:`main`: HMC on the non-centred model (``theta = mu + tau *
  theta_tilde``) and the :func:`~zhusuan_tpu_torch.diagnostics.summary`
  table. Its three latents take HMC's plain transition, as the JAX
  package's HMC gate (one latent) sends them to its scan path.
- :func:`funnel_diagnosis`: NUTS on the centred model, whose funnel makes
  divergent transitions at small ``tau``, and on the non-centred one, which
  removes them. Both run on the NUTS kernel on the card: their log-joints
  are the built-in
  :class:`~zhusuan_tpu_torch.ops.densities.EightSchoolsLogJoint`, the
  unconstrained density ``transform_log_joint`` would build from
  :func:`make_centered_log_joint` / :func:`make_log_joint`, which give the
  maps ``to_u`` / ``to_c``.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.hierarchical.eight_schools
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch import distributions as zd
from zhusuan_tpu_torch.bijectors import Softplus, transform_log_joint
from zhusuan_tpu_torch.diagnostics import summary
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import HMC, NUTS
from zhusuan_tpu_torch.ops.densities import EightSchoolsLogJoint

__all__ = ["Y", "SIGMA", "make_log_joint", "make_centered_log_joint",
           "funnel_density", "funnel_diagnosis", "main"]

# The classic data: estimated effects and standard errors per school.
Y = np.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMA = np.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def _tensors(device, dtype):
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(Y, **kw), torch.as_tensor(SIGMA, **kw),
            zd.HalfCauchy(torch.tensor(5.0, **kw)))


def make_log_joint(device=None, dtype=torch.float32):
    """The non-centred model over ``mu``, ``tau`` and ``theta_tilde [..., 8]``
    (constrained ``tau``)."""
    y, sig, hc = _tensors(device, dtype)

    def log_joint(obs):
        mu, tau, theta_t = obs["mu"], obs["tau"], obs["theta_tilde"]
        lp = -0.5 * (mu / 100.0) ** 2  # mu ~ N(0, 100): effectively flat
        lp = lp + hc.log_prob(tau)
        lp = lp + torch.sum(-0.5 * theta_t ** 2, dim=-1)
        theta = mu[..., None] + tau[..., None] * theta_t  # non-centred
        return lp + torch.sum(-0.5 * ((y - theta) / sig) ** 2, dim=-1)

    return log_joint


def make_centered_log_joint(device=None, dtype=torch.float32):
    """The centred model ``theta_j ~ N(mu, tau)``, the funnel that NUTS
    diagnoses (:func:`funnel_diagnosis`)."""
    y, sig, hc = _tensors(device, dtype)

    def log_joint(obs):
        mu, tau, theta = obs["mu"], obs["tau"], obs["theta"]
        lp = -0.5 * (mu / 100.0) ** 2
        lp = lp + hc.log_prob(tau)
        lp = lp + torch.sum(
            -0.5 * ((theta - mu[..., None]) / tau[..., None]) ** 2
            - torch.log(tau)[..., None], dim=-1)
        return lp + torch.sum(-0.5 * ((y - theta) / sig) ** 2, dim=-1)

    return log_joint


def funnel_density(centered):
    """The NUTS kernel's built-in for the unconstrained model, and the maps
    ``(to_u, to_c)`` of ``transform_log_joint`` on the closure."""
    closure = make_centered_log_joint() if centered else make_log_joint()
    _, to_u, to_c = transform_log_joint(closure, {"tau": Softplus()})
    return EightSchoolsLogJoint(Y, SIGMA, centered=centered), to_u, to_c


def funnel_init(centered, n_chains, device=None, dtype=torch.float32):
    """The JAX example's constrained initial state."""
    kw = dict(dtype=dtype, device=device)
    return {"mu": torch.zeros(n_chains, **kw),
            "tau": torch.full((n_chains,), 5.0, **kw),
            "theta" if centered else "theta_tilde":
                torch.zeros((n_chains, 8), **kw)}


def make_funnel_sampler():
    return NUTS(step_size=0.2, max_tree_depth=8, adapt_step_size=True)


def funnel_diagnosis(n_chains=32, n_iters=1000, n_adapt=500, verbose=True,
                     seed=7, device=None):
    """NUTS on the centred model, then on the non-centred one. Returns
    ``(centred divergence rate, non-centred divergence rate, share of the
    centred divergences at tau below its median)``, over the iterations
    after ``n_adapt``."""
    device = torch.device("cuda:0" if device is None else device)

    def run(centered, key):
        density, to_u, to_c = funnel_density(centered)
        nuts = make_funnel_sampler()
        state = nuts.init(to_u(funnel_init(centered, n_chains, device)),
                          n_chain_dims=1)
        state, out = nuts.run(density, {}, state, key, n_iters,
                              n_adapt=n_adapt,
                              collect_fields=("samples", "divergent"))
        draws = to_c({k: v[n_adapt:] for k, v in out["samples"].items()})
        return draws, out["divergent"][n_adapt:].cpu().numpy()

    c_draws, c_div = run(True, (seed, 1))
    _, nc_div = run(False, (seed, 2))
    c_rate, nc_rate = float(c_div.mean()), float(nc_div.mean())
    # Divergences are informative: they cluster where the funnel necks.
    tau = c_draws["tau"].double().cpu().numpy()
    tau_at = tau[c_div.astype(bool)]
    small_frac = (float(np.mean(tau_at < float(np.median(tau))))
                  if tau_at.size else float("nan"))
    if verbose:
        print("centered divergence rate     : %.3f" % c_rate)
        print("non-centered divergence rate : %.3f" % nc_rate)
        print("centered divergences at tau < median: %.2f" % small_frac)
    return c_rate, nc_rate, small_frac


def main(n_chains=64, n_iters=3000, n_adapt=1500, verbose=True, seed=0,
         device=None):
    """HMC on the non-centred model; returns ``(summary stats of mu, tau
    and theta, the theta draws [n_iters - n_adapt, n_chains, 8])``."""
    device = torch.device("cuda:0" if device is None else device)
    ulj, to_u, to_c = transform_log_joint(make_log_joint(device),
                                          {"tau": Softplus()})
    hmc = HMC(step_size=0.1, n_leapfrogs=10, adapt_step_size=True,
              adapt_mass=True)
    state = hmc.init(to_u(funnel_init(False, n_chains, device)),
                     n_chain_dims=1)
    state, out = hmc.run(ulj, {}, state, (seed, 0), n_iters, n_adapt=n_adapt)
    draws = to_c({k: v[n_adapt:] for k, v in out["samples"].items()})
    theta = draws["mu"][..., None] + draws["tau"][..., None] \
        * draws["theta_tilde"]
    stats, table = summary({"mu": draws["mu"], "tau": draws["tau"],
                            "theta": theta})
    theta = theta.double().cpu().numpy()
    if verbose:
        print(table)
        print("raw effects:", Y.round(1))
        print("posterior  :", theta.reshape(-1, 8).mean(0).round(1))
    return stats, theta


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--funnel", action="store_true",
                        help="run the NUTS funnel diagnosis instead")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.funnel:
        return funnel_diagnosis(device=device)
    return main(device=device)


if __name__ == "__main__":
    _cli()
