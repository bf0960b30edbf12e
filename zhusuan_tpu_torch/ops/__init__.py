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
same names), four entry points of one CUDA kernel body; and the Cholesky
factor with its inverse (:mod:`.linalg`, replacing ``ops/linalg.py::
_chol_inv_kernel``); and the whole-fit mean-field ADVI trainer
(:mod:`.advi_step`, replacing ``ops/advi_step.py::fused_meanfield_advi``);
and the standalone samplers (:mod:`.random`: ``gpu_normal`` and
``gpu_uniform``, replacing ``ops/random.py::tpu_normal`` and
``tpu_uniform``); and, replacing no TPU kernel, the one-pass effective
sample size of the diagnostics on the card (:mod:`.ess`). Every function
of the JAX package that reaches ``pl.pallas_call`` has its counterpart
here. The sampler and trainer kernels
evaluate the built-in densities of :mod:`.densities`; :mod:`.checks` holds
the numerics guards (no kernel). Kernels are built from
``zhusuan_tpu_torch/csrc`` at first use, never at import.
"""

from zhusuan_tpu_torch.ops.advi_step import (
    advi_layout,
    advi_step_supported,
    fused_meanfield_advi,
    fused_meanfield_advi_reference,
)
from zhusuan_tpu_torch.ops.checks import check_numerics, checked
from zhusuan_tpu_torch.ops.chees_step import (
    chees_step_supported,
    fused_chees_step,
    fused_chees_step_reference,
)
from zhusuan_tpu_torch.ops.densities import (
    BuiltinDensity,
    CovarianceEstimationLogJoint,
    DiagonalGaussianLogJoint,
    EightSchoolsLogJoint,
    EquicorrelatedGaussianLogJoint,
    GaussianLinearRegressionLogJoint,
    LatentDictDensity,
    NealFunnelLogJoint,
    NeuTraLogJoint,
    OrderedLogisticRegressionLogJoint,
    PoissonChangepointLogJoint,
    TemperedLogJoint,
    Toy2DLogJoint,
    WeibullAFTLogJoint,
    WhitenedLogJoint,
)
from zhusuan_tpu_torch.ops.ess import ess_layout, fused_ess
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
from zhusuan_tpu_torch.ops.linalg import (
    chol_inv_supported,
    cholesky_inverse,
    cholesky_inverse_panel_reference,
    cholesky_inverse_reference,
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
from zhusuan_tpu_torch.ops.random import (
    gpu_normal,
    gpu_normal_reference,
    gpu_uniform,
    gpu_uniform_reference,
    random_supported,
)
from zhusuan_tpu_torch.ops.sghmc_step import (
    fused_sghmc_step,
    fused_sghmc_step_reference,
    sghmc_step_supported,
)
from zhusuan_tpu_torch.ops.sgld_step import (
    fused_sgld_step,
    fused_sgld_step_reference,
    sgld_layout,
    sgld_step_supported,
)
from zhusuan_tpu_torch.ops.sgnht_step import (
    fused_sgnht_step,
    fused_sgnht_step_reference,
    sgnht_step_supported,
)

__all__ = [
    "BuiltinDensity",
    "CovarianceEstimationLogJoint",
    "DiagonalGaussianLogJoint",
    "EightSchoolsLogJoint",
    "EquicorrelatedGaussianLogJoint",
    "GaussianLinearRegressionLogJoint",
    "LatentDictDensity",
    "NealFunnelLogJoint",
    "NeuTraLogJoint",
    "OrderedLogisticRegressionLogJoint",
    "PoissonChangepointLogJoint",
    "TemperedLogJoint",
    "Toy2DLogJoint",
    "WeibullAFTLogJoint",
    "WhitenedLogJoint",
    "advi_layout",
    "advi_step_supported",
    "check_numerics",
    "checked",
    "chees_step_supported",
    "chol_inv_supported",
    "cholesky_inverse",
    "cholesky_inverse_panel_reference",
    "cholesky_inverse_reference",
    "ess_layout",
    "fused_chees_step",
    "fused_ess",
    "fused_chees_step_reference",
    "fused_hmc_step",
    "fused_hmc_step_reference",
    "fused_leapfrog",
    "fused_leapfrog_reference",
    "fused_meanfield_advi",
    "fused_meanfield_advi_reference",
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
    "gpu_normal",
    "gpu_normal_reference",
    "gpu_uniform",
    "gpu_uniform_reference",
    "hmc_step_supported",
    "leapfrog_supported",
    "nuts_step_supported",
    "psgld_step_supported",
    "random_supported",
    "sghmc_step_supported",
    "sgld_layout",
    "sgld_step_supported",
    "sgnht_step_supported",
]
