"""The chip's peaks and the least time of a piece of work.

Published rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit): 3.35 TB/s of HBM3 bandwidth and 67 TFLOP/s
of float32 outside the tensor cores. The kernels measured here compute in
float32 on the CUDA cores, so that is their peak. A card set below 700 W
runs slower under load; the run prints the card's limit beside its
numbers.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
POWER_LIMIT_W = 700.0

# Operations per element that Philox4x32-10 and Box-Muller take for one
# normal (the ten rounds' multiplies, xors and key adds per 4 normals;
# log, sqrt, cos or sin and the products per 2). Integer operations are
# counted at the float32 rate. A density's own work is its target's
# (``reference/targets/<target>.py::cost``).
OPS_NORMAL = 50


def least_time(n_bytes: float, n_ops: float):
    """``{"seconds", "bound_by", "bytes", "ops"}``: the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return {"seconds": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}
