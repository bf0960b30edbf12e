"""ZhuSuan on PyTorch and CUDA: the port of ``zhusuan_tpu`` to an NVIDIA
H100.

Imports ``torch`` and never ``jax``. Module names mirror ``zhusuan_tpu``.
Ported so far: adaptive HMC and NUTS, each with its hand-written CUDA
transition kernel (:mod:`.mcmc`, :mod:`.ops`), the ESS diagnostics
(:mod:`.diagnostics`) and the utilities they use (:mod:`.utils`).
"""

from zhusuan_tpu_torch import diagnostics, mcmc, ops, utils
from zhusuan_tpu_torch.mcmc import HMC, NUTS, HMCInfo, HMCState, NUTSInfo
from zhusuan_tpu_torch.ops import DiagonalGaussianLogJoint

__all__ = [
    "HMC",
    "HMCInfo",
    "HMCState",
    "NUTS",
    "NUTSInfo",
    "DiagonalGaussianLogJoint",
    "diagnostics",
    "mcmc",
    "ops",
    "utils",
]
