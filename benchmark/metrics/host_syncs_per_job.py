"""Host reads of a device value in the profiled job: the program's
``zs.sync.*`` spans (HMC's step-size search trials, the plain paths'
reads, ``check_numerics``), counted; 0 where the job made none."""

from benchmark import program_spans

NAME = "host_syncs_per_job"
UNIT = "count"
LAYER = "transitions (HMC.sample, NUTS.sample, ChEESHMC.sample)"
MOVES = "job_p90_s"
SOURCE = "program_span"


def read(run):
    found = program_spans.of(run)
    if found is None:
        return None
    return float(len(found.named("zs.sync.")))
