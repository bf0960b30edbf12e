"""K1, the whole HMC transition (``ops/hmc_step.py``, ``csrc/hmc_step.cu``
step mode).

Counted per launch on ``[c, d]`` float32 chains: it reads q and writes q'
and the momentum p0 (``3 c d`` floats), five floats per chain, the mass
(``d``) and the density's parameters. Per element: a normal, the momentum
(2), two kinetic energies (6), the select (1) and, in each of the
``n_leapfrogs + 1`` sub-steps, the drift (3) and the kick (2); per chain
the target's two log-densities and ``n_leapfrogs + 1`` gradients
(``cost``: ``reference/targets/<target>.py``). A bfloat16 state moves
half the bytes of q and q'; that is not counted here, as the cells run
float32 state.
"""

from benchmark.roofline.peaks import OPS_NORMAL, least_time

PATTERN = r"hmc_family_kernel<.*,\s*0>\("


def launch(c: int, d: int, n_leapfrogs: int, cost):
    ops = c * (d * (OPS_NORMAL + 2 + 6 + 1 + (n_leapfrogs + 1) * 5)
               + 2 * cost["log_prob_ops"]
               + (n_leapfrogs + 1) * cost["grad_ops"])
    return least_time(4 * (3 * c * d + 5 * c + d) + cost["param_bytes"], ops)
