"""K1, the whole HMC transition (``ops/hmc_step.py``, ``csrc/hmc_step.cu``
step mode).

Counted per launch on ``[c, d]`` float32 chains: it reads q and writes q'
and the momentum p0 (``3 c d`` floats), five floats per chain, and the
mass, loc and inverse variance (``3 d``). Per element: a normal, the
momentum (2), two kinetic energies (6), two log-densities, the
``n_leapfrogs + 1`` sub-steps (drift 3, gradient, kick 2) and the select.
A bfloat16 state moves half the bytes of q and q'; that is not counted
here, as the cells run float32 state.
"""

from benchmark.roofline.peaks import (
    OPS_GRAD,
    OPS_LOG_PROB,
    OPS_NORMAL,
    least_time,
)

PATTERN = r"hmc_family_kernel<.*,\s*0>\("


def launch(c: int, d: int, n_leapfrogs: int):
    ops = (OPS_NORMAL + 2 + 6 + 2 * OPS_LOG_PROB + 1
           + (n_leapfrogs + 1) * (5 + OPS_GRAD))
    return least_time(4 * (3 * c * d + 5 * c + 3 * d), c * d * ops)
