"""K8/K9, the whole NUTS transition (``ops/nuts_step.py``,
``csrc/nuts_step.cu``), one kernel for every depth.

Counted per launch on ``[c, d]`` float32 chains with the leapfrog steps
the trees of that iteration took, summed over the chains
(``NUTSInfo.n_leapfrogs``): it reads q and writes q' (``2 c d`` floats),
eight values per chain and the mass and the density's two vectors
(``2 d``); per element a normal, and per leapfrog step and element the
drift, gradient and kick, the leaf's energy and the U-turn products
(about 20).
"""

from benchmark.roofline.peaks import OPS_NORMAL, least_time

PATTERN = r"fused_nuts_kernel<"


def launch(c: int, d: int, total_leapfrogs: int):
    return least_time(4 * (2 * c * d + 8 * c + 2 * d),
                      c * d * OPS_NORMAL + total_leapfrogs * d * 20)
