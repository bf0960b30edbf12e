"""A checkpoint written by the JAX package, for ``chip_smoke.py`` phase 37
to restore into the port on the GPU host (which has no jax):
``scripts/checkpoint_jax_reference.npz``.

The tree is ``{"hmc": HMCState, "bf16": [2, 3] bfloat16}``: adaptive HMC
(dual averaging and mass adaptation on) over four chains of a 3-dim
diagonal Gaussian in float32, after ``STEPS`` iterations from key
``KEY``, and the bfloat16 leaf ``arange(6) / 2`` (exact in bfloat16). It is
saved with ``zhusuan_tpu.checkpoint.save_checkpoint(..., step=STEPS,
use_orbax=False)`` on the CPU with x64 on (the tests' setting; the state's
arrays are float32 all the same). ``tests/test_torch_checkpoint.py``
checks that the committed file equals what this script writes now.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/checkpoint_jax_reference.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import zhusuan_tpu as zs  # noqa: E402
from zhusuan_tpu.checkpoint import save_checkpoint  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "checkpoint_jax_reference.npz")
STEPS = 3
KEY = 18
STD = (0.5, 1.0, 2.0)


def log_joint(obs):
    std = jnp.asarray(STD, jnp.float32)
    return jnp.sum(-0.5 * (obs["x"] / std) ** 2, -1)


def reference_tree():
    """The tree the file holds, made afresh."""
    hmc = zs.HMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True,
                 adapt_mass=True, mass_collect_iters=2)
    q0 = jnp.asarray(np.linspace(-1.0, 1.0, 12).reshape(4, 3), jnp.float32)
    state = hmc.init({"x": q0}, log_joint=log_joint)
    key = jax.random.PRNGKey(KEY)
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        state, _ = hmc.sample(log_joint, {}, state, sub)
    bf16 = (jnp.arange(6, dtype=jnp.float32) / 2).reshape(2, 3)
    return {"hmc": state, "bf16": bf16.astype(jnp.bfloat16)}


def write(path):
    return save_checkpoint(path, reference_tree(), step=STEPS,
                           use_orbax=False)


def main():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(write(OUT))


if __name__ == "__main__":
    main()
