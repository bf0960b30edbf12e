"""The share of its roofline that chees_step's kernel reaches in the profiled
job: the least time of each launch's work (``roofline/chees_step.py``) over
the launch's time in the device trace."""

from benchmark.metrics._common import kernel_share

NAME = "chees_step_roofline"
UNIT = "%"
LAYER = "kernel K7 (ops/chees_step.py, csrc/hmc_step.cu)"
MOVES = "draws_per_s"
SOURCE = "device_trace"


def read(run):
    return kernel_share(run, "chees_step")
