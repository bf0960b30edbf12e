"""K7, the ChEES transition (``ops/chees_step.py``, ``csrc/hmc_step.cu``
ChEES mode): K1's work with the proposal ``(q', p')`` also written.

Counted per launch on ``[c, d]`` float32 chains with the leapfrog count
the sampler drew for that iteration: it reads q and writes the kept q',
the proposal q' and p' (``4 c d`` floats), three floats per chain, the
mass (``d``, ones: the cells run unit mass) and the density's
parameters; the operations of :func:`.hmc_step.launch`.
"""

from benchmark.roofline import hmc_step
from benchmark.roofline.peaks import least_time

PATTERN = r"hmc_family_kernel<.*,\s*1>\("


def launch(c: int, d: int, n_leapfrogs: int, cost):
    ops = hmc_step.launch(c, d, n_leapfrogs, cost)["ops"]
    return least_time(4 * (4 * c * d + 3 * c + d) + cost["param_bytes"], ops)
