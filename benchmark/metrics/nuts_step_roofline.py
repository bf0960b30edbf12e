"""The share of its roofline that nuts_step's kernel reaches in the profiled
job: the least time of each launch's work (``roofline/nuts_step.py``) over
the launch's time in the device trace."""

from benchmark.metrics._common import kernel_share

NAME = "nuts_step_roofline"
UNIT = "%"
LAYER = "kernel K8/K9 (ops/nuts_step.py, csrc/nuts_step.cu)"
MOVES = "draws_per_s"
SOURCE = "device_trace"


def read(run):
    return kernel_share(run, "nuts_step")
