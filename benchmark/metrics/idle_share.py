"""The share of the profiled job's wall time (``init`` to the ESS read)
in which no operation ran on the device."""

NAME = "idle_share"
UNIT = "%"
LAYER = "device"
MOVES = "draws_per_s"
SOURCE = "device_trace"


def read(run):
    lo, hi = run.trace.window()
    busy = run.trace.busy()
    return 100.0 * (1.0 - busy / (hi - lo)) if busy > 0 else None
