"""K8/K9, the whole NUTS transition (``ops/nuts_step.py``,
``csrc/nuts_step.cu``), one kernel for every depth.

Counted per launch on ``[c, d]`` float32 chains with the leapfrog steps
the trees of that iteration took, summed over the chains
(``NUTSInfo.n_leapfrogs``): it reads q and writes q' (``2 c d`` floats),
eight values per chain, the inverse mass (``d``) and the density's
parameters; per element a normal, and per leapfrog step and element the
drift, the kick, the leaf's kinetic energy and the U-turn products
(about 12), beside the target's gradient and log-density at the leaf
(``cost``: ``reference/targets/<target>.py``).
"""

from benchmark.roofline.peaks import OPS_NORMAL, least_time

PATTERN = r"fused_nuts_kernel<"


def launch(c: int, d: int, total_leapfrogs: int, cost):
    ops = c * d * OPS_NORMAL + total_leapfrogs * (
        12 * d + cost["grad_ops"] + cost["log_prob_ops"])
    return least_time(4 * (2 * c * d + 8 * c + d) + cost["param_bytes"], ops)
