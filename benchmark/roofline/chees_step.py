"""K7, the ChEES transition (``ops/chees_step.py``, ``csrc/hmc_step.cu``
ChEES mode): K1's work with the proposal ``(q', p')`` also written.

Counted per launch on ``[c, d]`` float32 chains with the leapfrog count
the sampler drew for that iteration: it reads q and writes the kept q',
the proposal q' and p' (``4 c d`` floats), three floats per chain and the
density's parameters (``d``); per element the work of
:func:`.hmc_step.launch`.
"""

from benchmark.roofline.peaks import (
    OPS_GRAD,
    OPS_LOG_PROB,
    OPS_NORMAL,
    least_time,
)

PATTERN = r"hmc_family_kernel<.*,\s*1>\("


def launch(c: int, d: int, n_leapfrogs: int):
    ops = (OPS_NORMAL + 2 + 6 + 2 * OPS_LOG_PROB + 1
           + (n_leapfrogs + 1) * (5 + OPS_GRAD))
    return least_time(4 * (4 * c * d + 3 * c + d), c * d * ops)
