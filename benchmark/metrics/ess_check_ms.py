"""Milliseconds of the job's ESS check (``diagnostics.ess_batch_device``
over every chain and dimension and the host read of the job's ESS), from
its span, averaged over the traced window's jobs."""

NAME = "ess_check_ms"
UNIT = "ms"
LAYER = "diagnostics (diagnostics.py::ess_batch_device)"
MOVES = "job_p90_s"
SOURCE = "program_span"


def read(run):
    s = run.span_mean("ess")
    return None if s is None else 1e3 * s
