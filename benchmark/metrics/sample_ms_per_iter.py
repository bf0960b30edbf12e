"""Milliseconds an iteration of the job's sampling ``run``, from the
stage's span closed by a synchronize, averaged over the traced window's
jobs."""

NAME = "sample_ms_per_iter"
UNIT = "ms"
LAYER = "run loop (mcmc/{hmc,nuts,chees}.py run, mcmc/base.py::run_driver)"
MOVES = "draws_per_s"
SOURCE = "program_span"


def read(run):
    s = run.span_mean("sample")
    return None if s is None else 1e3 * s / run.cell["n_sample"]
