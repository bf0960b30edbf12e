"""Milliseconds of adaptation an iteration of the profiled job's warm-up:
the program's ``zs.adapt.*`` spans (dual averaging, the mass's moving
variance and install, ChEES's trajectory Adam) inside ``bench.warmup``,
summed, over ``n_warmup``. The profiled job's host runs slower than the
others' (the profiler records every call)."""

from benchmark import program_spans

NAME = "adapt_ms_per_iter"
UNIT = "ms"
LAYER = ("adaptation (mcmc/base.py dual_averaging_update, ewmv_update; "
         "hmc.py mass_update; chees.py Adam)")
MOVES = "job_p90_s"
SOURCE = "program_span"


def read(run):
    found = program_spans.of(run)
    if found is None:
        return None
    spans = found.named("zs.adapt.", "bench.warmup")
    return 1e3 * sum(s["dur"] for s in spans) / run.cell["n_warmup"]
