"""The whole sampling iteration's share of the chip's peak: the least
time of the transition's necessary work (the cell's kernel count from the
shapes, the target's own work and the leapfrogs taken,
``roofline/<kernel>.py``) plus the collected draw written, over
``sample_ms_per_iter``. It does not depend on what implements the
transition."""

import torch

from benchmark.metrics._common import launch_counts, roofline
from benchmark.roofline.peaks import least_time

NAME = "step_mfu"
UNIT = "%"
LAYER = "whole sampling iteration"
MOVES = "draws_per_s"
SOURCE = "program_span"


def read(run):
    span = run.span_mean("sample")
    if span is None:
        return None
    cell = run.cell
    mod = roofline(cell["kernel"])
    c, d = cell["chains"], run.dim
    collect = getattr(torch, cell.get("collect_dtype", "float32"))
    written = c * d * torch.empty((), dtype=collect).element_size()
    counts = launch_counts(run)[cell["n_warmup"]:]
    least = 0.0
    for n in counts:
        work = mod.launch(c, d, n, run.cost)
        least += least_time(work["bytes"] + written, work["ops"])["seconds"]
    return 100.0 * least / span
