"""Arithmetic the metric readers share."""

from __future__ import annotations

import importlib


def roofline(name: str):
    return importlib.import_module("benchmark.roofline." + name)


def launch_counts(run):
    """The profiled job's per-iteration work, in launch order (warm-up,
    then sampling): leapfrog steps per chain (HMC, ChEES) or summed over
    chains (NUTS)."""
    return run.profiled["launches"]()


def kernel_share(run, kernel: str):
    """A kernel's roofline share (%) over its launches in the profiled job:
    the least time of each launch's work summed, over the kernel's time in
    the trace; None where the kernel did not run, or ran another number of
    times than the job has iterations."""
    mod = roofline(kernel)
    times = run.trace.kernels(mod.PATTERN)
    counts = launch_counts(run)
    if not times or len(times) != len(counts):
        return None
    c = run.cell["chains"]
    least = sum(mod.launch(c, run.dim, n, run.cost)["seconds"]
                for n in counts)
    return 100.0 * least / sum(t for _, t in times)
