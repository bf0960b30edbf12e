"""Device operations (kernels, copies, fills) an iteration of the
profiled job's sampling ``run``, counted in the device trace."""

NAME = "device_ops_per_iter"
UNIT = "ops"
LAYER = "transitions (HMC.sample, NUTS.sample, ChEESHMC.sample)"
MOVES = "draws_per_s"
SOURCE = "device_trace"


def read(run):
    ops = run.trace.in_stage("bench.sample")
    return len(ops) / run.cell["n_sample"] if ops else None
