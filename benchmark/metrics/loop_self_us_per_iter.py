"""Microseconds of an iteration of the profiled job's sampling ``run``
outside every span inside it: the mean self time of the program's
``zs.iter`` spans (``run_driver``'s call of the sampler's ``sample``,
less its transition, adaptation and host reads) inside ``bench.sample``:
the samplers' glue between the spans."""

from benchmark import program_spans

NAME = "loop_self_us_per_iter"
UNIT = "us"
LAYER = "run loop (mcmc/{hmc,nuts,chees}.py run, mcmc/base.py::run_driver)"
MOVES = "draws_per_s"
SOURCE = "program_span"


def read(run):
    found = program_spans.of(run)
    if found is None:
        return None
    return program_spans.mean_us(
        found.named("zs.iter", "bench.sample"), "self")
