"""Drive a cell's jobs and its check on the CPU at a small size.

The kernels run only on the card. On the CPU each kernel wrapper runs its
plain version, which draws the kernel's own Philox numbers, so the tests
route the samplers' transitions through the wrappers (``route_kernels``)
and then drive the harness's job loop and check as a run does, without
its look for a card.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import harness


@contextlib.contextmanager
def route_kernels():
    """Send every eligible transition to the kernel wrappers on the CPU."""
    from zhusuan_tpu_torch.mcmc import chees, hmc, nuts

    saved = {m: m.use_kernel for m in (hmc, nuts, chees)}

    def use(flag, q, ineligible):
        return bool(flag) and ineligible() is None

    for m in saved:
        m.use_kernel = use
    try:
        yield
    finally:
        for m, f in saved.items():
            m.use_kernel = f


def small_cell(name: str, **changes):
    """The cell ``name`` with its sizes cut for the CPU."""
    cell, config = harness.load_cell(name)
    cell.update(changes)
    return cell, config


def run(cell, config, seed: int, n_jobs: int = 2):
    """``(records, kept job, check numbers, correct)`` of ``n_jobs`` jobs on
    the CPU, the last one checked."""
    driver = harness.module("samplers", cell["sampler"])
    ctx = harness.context(cell, config, torch.device("cpu"), seed)
    with route_kernels():
        driver.build(ctx)
        jobs, kept = [], None
        for index in range(n_jobs):
            rec = harness.run_job(torch, driver, ctx, index)
            keep = rec.pop("keep", None)
            if keep is not None:
                kept = (index, keep)
            jobs.append(rec)
    numbers = harness.module("reference", cell["sampler"]).check(
        kept[1], cell, config)
    correct, _ = harness.judge(numbers, cell["limits"])
    return jobs, kept, numbers, correct and not any(j["failed"] for j in jobs)
