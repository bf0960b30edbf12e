"""HMC jobs (kernel K1): ``HMC.init``, a warm-up ``HMC.run`` with step
size and mass adapted, a sampling ``HMC.run`` that collects the draws in
the cell's ``collect_dtype``, then the ESS check."""

from __future__ import annotations

import torch

from benchmark.samplers import _job

# The kernel wrapper whose launch counter confirms the route.
ROUTE = "zhusuan_tpu_torch.ops.hmc_step:fused_hmc_step"


def build(ctx):
    _job.build(ctx, "HMC")


release = _job.release


def job(ctx, index, spans):
    cell, hmc, dens = ctx["cell"], ctx["sampler"], ctx["density"]
    target = ctx["target"]
    nw, ns = cell["n_warmup"], cell["n_sample"]
    key, q0 = _job.start(ctx, index)
    with spans.stage("warmup"):
        state = hmc.init(target.latents(q0), n_chain_dims=1)
        state, _ = hmc.run(dens, {}, state, key, nw, n_adapt=nw,
                           collect=False)
    warm = {"warm_q": target.flat(state.q), "step_size": state.step_size,
            "log_step_bar": state.log_epsilon_bar,
            "mass": target.flat(state.mass)}
    with spans.stage("sample"):
        state, out = hmc.run(dens, {}, state, key, ns, n_adapt=0,
                             collect_fields=("samples",),
                             collect_dtype=getattr(torch,
                                                   cell["collect_dtype"]))
    draws = target.flat(out["samples"])
    ess = _job.ess_stage(ctx, spans, draws)
    keep = {"key": key, "q0": q0, "samples": draws, "ess": ess,
            "check_seed": _job.check_seed(ctx, index), **warm}
    return {"ess": ess, "keep": keep,
            "launches": lambda: [cell["args"]["n_leapfrogs"]] * (nw + ns)}
