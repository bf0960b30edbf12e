"""Microseconds of host time to issue one transition in the profiled
job's sampling ``run``: the mean duration of the program's
``zs.transition`` spans (the kernel wrapper's call and launch, or the
plain trajectory and its MH test) inside ``bench.sample``."""

from benchmark import program_spans

NAME = "transition_host_us"
UNIT = "us"
LAYER = "transitions (HMC.sample, NUTS.sample, ChEESHMC.sample)"
MOVES = "draws_per_s"
SOURCE = "program_span"


def read(run):
    found = program_spans.of(run)
    if found is None:
        return None
    return program_spans.mean_us(
        found.named("zs.transition", "bench.sample"), "dur")
