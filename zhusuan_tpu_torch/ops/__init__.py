"""Hand-written CUDA kernels of the port and their plain torch versions.

Counterpart of ``zhusuan_tpu/ops``. Ported so far: the fused HMC
transition (:mod:`.hmc_step`, replacing the Pallas kernel
``zhusuan_tpu/ops/hmc_step.py::fused_hmc_step``), the fused ChEES
transition (:mod:`.chees_step`, replacing ``ops/chees_step.py::
fused_chees_step``) and the fused leapfrog trajectory (:mod:`.leapfrog`,
replacing ``ops/leapfrog.py::fused_leapfrog``), three entry points of one
CUDA kernel body; and the fused NUTS transition (:mod:`.nuts_step`, one
kernel replacing both ``zhusuan_tpu/ops/nuts_step.py::
fused_nuts_transition`` and ``fused_nuts_transition_looped``); and the
fused SGMCMC updates (:mod:`.sgld_step`, :mod:`.psgld_step`,
:mod:`.sghmc_step`, :mod:`.sgnht_step`, replacing the Pallas kernels of the
same names), four entry points of one CUDA kernel body. The kernels
evaluate the built-in densities of :mod:`.densities`. Kernels are built
from ``zhusuan_tpu_torch/csrc`` at first use, never at import.
"""

from zhusuan_tpu_torch.ops.chees_step import (
    chees_step_supported,
    fused_chees_step,
    fused_chees_step_reference,
)
from zhusuan_tpu_torch.ops.densities import (
    BuiltinDensity,
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import (
    fused_hmc_step,
    fused_hmc_step_reference,
    hmc_step_supported,
)
from zhusuan_tpu_torch.ops.leapfrog import (
    fused_leapfrog,
    fused_leapfrog_reference,
    leapfrog_supported,
)
from zhusuan_tpu_torch.ops.nuts_step import (
    fused_nuts_transition,
    fused_nuts_transition_reference,
    nuts_step_supported,
)
from zhusuan_tpu_torch.ops.psgld_step import (
    fused_psgld_step,
    fused_psgld_step_reference,
    psgld_step_supported,
)
from zhusuan_tpu_torch.ops.sghmc_step import (
    fused_sghmc_step,
    fused_sghmc_step_reference,
    sghmc_step_supported,
)
from zhusuan_tpu_torch.ops.sgld_step import (
    fused_sgld_step,
    fused_sgld_step_reference,
    sgld_step_supported,
)
from zhusuan_tpu_torch.ops.sgnht_step import (
    fused_sgnht_step,
    fused_sgnht_step_reference,
    sgnht_step_supported,
)

__all__ = [
    "BuiltinDensity",
    "DiagonalGaussianLogJoint",
    "EquicorrelatedGaussianLogJoint",
    "chees_step_supported",
    "fused_chees_step",
    "fused_chees_step_reference",
    "fused_hmc_step",
    "fused_hmc_step_reference",
    "fused_leapfrog",
    "fused_leapfrog_reference",
    "fused_nuts_transition",
    "fused_nuts_transition_reference",
    "fused_psgld_step",
    "fused_psgld_step_reference",
    "fused_sghmc_step",
    "fused_sghmc_step_reference",
    "fused_sgld_step",
    "fused_sgld_step_reference",
    "fused_sgnht_step",
    "fused_sgnht_step_reference",
    "hmc_step_supported",
    "leapfrog_supported",
    "nuts_step_supported",
    "psgld_step_supported",
    "sghmc_step_supported",
    "sgld_step_supported",
    "sgnht_step_supported",
]
