"""NeuTra-lifted HMC on Neal's funnel.

Port of ``examples/toy_examples/neal_funnel_neutra.py``: ``v ~ N(0, 3)``,
``x_i | v ~ N(0, e^{v/2})`` (4 funnel coordinates), where adapted
diagonal-mass HMC cannot enter the funnel's neck and underestimates
``std(v) = 3``. A RealNVP transport fitted by SGVB
(:func:`~zhusuan_tpu_torch.mcmc.fit_neutra`) bends the geometry toward a
standard normal; HMC in the flow's latent coordinates explores the whole
funnel (Hoffman et al. 2019, arXiv:1903.03704).

The funnel is the built-in :class:`~zhusuan_tpu_torch.ops.densities.
NealFunnelLogJoint` and its lift through the fitted flow the built-in
:class:`~zhusuan_tpu_torch.ops.densities.NeuTraLogJoint`, so on the card
both HMC runs take the HMC kernel, one launch an iteration, as the JAX
package traces the closures into its Pallas kernel on a TPU.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.toy_examples.neal_funnel_neutra
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import HMC, fit_neutra, neutra_log_joint
from zhusuan_tpu_torch.ops.densities import NealFunnelLogJoint

__all__ = ["D", "log_joint", "make_hmc", "run_hmc", "run", "main"]

D = 5  # v + 4 funnel coordinates

#: ``log p = -0.5 (v / 3)^2 + sum_i (-0.5 (x_i / e^{v/2})^2 - v / 2)``
#: over ``z = [v, x_1 .. x_4]``, a built-in the HMC kernel evaluates.
log_joint = NealFunnelLogJoint("z", D, v_scale=3.0)


def make_hmc():
    """The example's sampler (step 0.1, 8 leapfrogs, step size and mass
    adapted toward acceptance 0.8)."""
    return HMC(step_size=0.1, n_leapfrogs=8, adapt_step_size=True,
               adapt_mass=True, target_acceptance_rate=0.8)


def run_hmc(lj, key, n_chains=512, n_iters=1000, n_adapt=500,
            dtype=torch.float32, device=None):
    """``n_iters`` iterations (adapting over the first ``n_adapt``) from
    zeros; the kept samples ``[n_iters - n_adapt, n_chains, D]``."""
    hmc = make_hmc()
    state = hmc.init({"z": torch.zeros((n_chains, D), dtype=dtype,
                                       device=device)}, log_joint=lj)
    _, out = hmc.run(lj, {}, state, key, n_iters, n_adapt=n_adapt,
                     collect_fields=("samples",))
    return out["samples"]["z"][n_adapt:]


def run(device, n_flows=8, n_fit_iters=2000, seed=0, n_chains=512,
        n_iters=1000, n_adapt=500, dtype=torch.float32, verbose=True):
    """``(std_plain, std_neutra, fit)``: ``std(v)`` of plain HMC and of
    NeuTra HMC (true 3), and the flow fit."""
    device = torch.device(device)
    plain = run_hmc(log_joint, (seed, 1), n_chains, n_iters, n_adapt,
                    dtype, device)
    v_plain = plain[..., 0].double().reshape(-1)
    std_plain = float(v_plain.std(unbiased=False))
    if verbose:
        print("plain HMC:   std(v) = {:.2f} (true 3.00), min v = {:.1f}"
              .format(std_plain, float(v_plain.min())))
    fit = fit_neutra(log_joint, "z", D,
                     torch.Generator(device=device).manual_seed(seed),
                     n_flows=n_flows, n_iters=n_fit_iters, n_particles=64,
                     learning_rate=2e-3, dtype=dtype)
    if verbose:
        losses = fit.losses.cpu().numpy()
        print("flow fit:    -ELBO {:.2f} -> {:.2f}".format(
            float(np.mean(losses[:100])), float(np.mean(losses[-100:]))))
    lat_lj, _, from_lat = neutra_log_joint(log_joint, "z", fit.params)
    lat = run_hmc(lat_lj, (seed, 2), n_chains, n_iters, n_adapt, dtype,
                  device)
    with torch.no_grad():
        v_neutra = from_lat(lat)[..., 0].double().reshape(-1)
    std_neutra = float(v_neutra.std(unbiased=False))
    if verbose:
        print("NeuTra HMC:  std(v) = {:.2f} (true 3.00), min v = {:.1f}"
              .format(std_neutra, float(v_neutra.min())))
    return std_plain, std_neutra, fit


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_flows", default=8, type=int)
    parser.add_argument("--n_fit_iters", default=2000, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--n_chains", default=512, type=int)
    parser.add_argument("--n_iters", default=1000, type=int)
    parser.add_argument("--n_adapt", default=500, type=int)
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    std_plain, std_neutra, _ = run(
        resolve_device(hps.device), hps.n_flows, hps.n_fit_iters, hps.seed,
        hps.n_chains, hps.n_iters, hps.n_adapt)
    return std_plain, std_neutra


if __name__ == "__main__":
    main()
