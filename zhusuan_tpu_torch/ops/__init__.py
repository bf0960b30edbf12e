"""Hand-written CUDA kernels of the port and their plain torch versions.

Counterpart of ``zhusuan_tpu/ops``. Ported so far: the fused HMC
transition (:mod:`.hmc_step`, replacing the Pallas kernel
``zhusuan_tpu/ops/hmc_step.py::fused_hmc_step``) and the fused NUTS
transition (:mod:`.nuts_step`, one kernel replacing both
``zhusuan_tpu/ops/nuts_step.py::fused_nuts_transition`` and
``fused_nuts_transition_looped``). Kernels are built from
``zhusuan_tpu_torch/csrc`` at first use, never at import.
"""

from zhusuan_tpu_torch.ops.hmc_step import (
    DiagonalGaussianLogJoint,
    fused_hmc_step,
    fused_hmc_step_reference,
    hmc_step_supported,
)
from zhusuan_tpu_torch.ops.nuts_step import (
    fused_nuts_transition,
    fused_nuts_transition_reference,
    nuts_step_supported,
)

__all__ = [
    "DiagonalGaussianLogJoint",
    "fused_hmc_step",
    "fused_hmc_step_reference",
    "fused_nuts_transition",
    "fused_nuts_transition_reference",
    "hmc_step_supported",
    "nuts_step_supported",
]
