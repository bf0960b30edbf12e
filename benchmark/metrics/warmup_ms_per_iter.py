"""Milliseconds an iteration of the job's ``init`` and warm-up ``run``
(adaptation on), from the stage's span closed by a synchronize, averaged
over the traced window's jobs."""

NAME = "warmup_ms_per_iter"
UNIT = "ms"
LAYER = "run loop (mcmc/{hmc,nuts,chees}.py run, mcmc/base.py::run_driver)"
MOVES = "job_p90_s"
SOURCE = "program_span"


def read(run):
    s = run.span_mean("warmup")
    return None if s is None else 1e3 * s / run.cell["n_warmup"]
