"""ChEES-HMC jobs (kernel K7): ``ChEESHMC.init``, a warm-up
``ChEESHMC.run`` with the step size and the trajectory length adapted, a
sampling ``ChEESHMC.run``, then the ESS check. Both runs collect what
``ChEESHMC.run`` stacks: the float32 draws, the acceptance, the
trajectory lengths and the leapfrog counts."""

from __future__ import annotations

from benchmark.samplers import _job

# The kernel wrapper whose launch counter confirms the route.
ROUTE = "zhusuan_tpu_torch.ops.chees_step:fused_chees_step"


def build(ctx):
    _job.build(ctx, "ChEESHMC")


release = _job.release


def job(ctx, index, spans):
    cell, chees, dens = ctx["cell"], ctx["sampler"], ctx["density"]
    target = ctx["target"]
    nw, ns = cell["n_warmup"], cell["n_sample"]
    key, q0 = _job.start(ctx, index)
    with spans.stage("warmup"):
        state = chees.init(target.latents(q0))
        state, warm = chees.run(dens, {}, state, key, nw, n_adapt=nw)
    with spans.stage("sample"):
        state, out = chees.run(dens, {}, state, key, ns, n_adapt=0)
    draws = target.flat(out["samples"])
    ess = _job.ess_stage(ctx, spans, draws)
    keep = {"key": key, "q0": q0, "ess": ess, "step_size": state.step_size,
            "check_seed": _job.check_seed(ctx, index),
            "warm_samples": target.flat(warm["samples"]),
            "warm_length": warm["trajectory_length"],
            "warm_accept": warm["acceptance_rate"],
            "accept": out["acceptance_rate"],
            "warm_leapfrogs": warm["n_leapfrogs"],
            "samples": draws, "leapfrogs": out["n_leapfrogs"]}
    counts = [warm["n_leapfrogs"], out["n_leapfrogs"]]
    return {"ess": ess, "keep": keep,
            "launches": lambda: [int(x) for part in counts
                                 for x in part.reshape(-1).tolist()]}
