"""NUTS jobs (kernels K8/K9): ``NUTS.init``, a warm-up ``NUTS.run`` with
adaptation on, a sampling ``NUTS.run``, then the ESS check. Both runs
collect the draws (float32: ``NUTS.run`` stacks the state's dtype), the
acceptance statistics, the step sizes and the leapfrog counts."""

from __future__ import annotations

from benchmark.samplers import _job

# The kernel wrapper whose launch counter confirms the route.
ROUTE = "zhusuan_tpu_torch.ops.nuts_step:fused_nuts_transition"

FIELDS = ("samples", "acceptance_rate", "step_size", "n_leapfrogs")


def build(ctx):
    _job.build(ctx, "NUTS")


release = _job.release


def job(ctx, index, spans):
    cell, nuts, dens = ctx["cell"], ctx["sampler"], ctx["density"]
    target = ctx["target"]
    nw, ns = cell["n_warmup"], cell["n_sample"]
    key, q0 = _job.start(ctx, index)
    with spans.stage("warmup"):
        state = nuts.init(target.latents(q0), n_chain_dims=1)
        state, warm = nuts.run(dens, {}, state, key, nw, n_adapt=nw,
                               collect_fields=FIELDS)
    mass = target.flat(state.mass)
    with spans.stage("sample"):
        state, out = nuts.run(dens, {}, state, key, ns, n_adapt=0,
                              collect_fields=FIELDS)
    draws = target.flat(out["samples"])
    ess = _job.ess_stage(ctx, spans, draws)
    keep = {"key": key, "q0": q0, "ess": ess, "mass": mass,
            "check_seed": _job.check_seed(ctx, index),
            "warm_samples": target.flat(warm["samples"]),
            "warm_accept": warm["acceptance_rate"],
            "warm_step": warm["step_size"],
            "samples": draws, "accept": out["acceptance_rate"],
            "step": out["step_size"]}
    leaps = [warm["n_leapfrogs"], out["n_leapfrogs"]]
    return {"ess": ess, "keep": keep,
            "launches": lambda: [int(x) for part in leaps
                                 for x in part.sum(dim=1).tolist()]}
