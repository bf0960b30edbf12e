"""Random numbers of the port's kernels, of their plain versions, and of
the samplers' plain paths.

Counterparts of ``zhusuan_tpu/ops/_pallas_utils.py::uniform_from_bits`` and
``split_boxmuller_normal`` and of ``zhusuan_tpu/ops/random.py::_key_to_seed``.
The TPU kernels draw from the TPU's hardware PRNG; a CUDA kernel has none,
so the port writes Philox4x32-10 (Salmon et al., SC'11) into the kernels by
hand (``csrc/philox.cuh``) and keeps this plain torch version beside it:
both give the same bits for the same key and counter, so a kernel's plain
version (``ops/hmc_step.py::fused_hmc_step_reference``,
``ops/nuts_step.py::fused_nuts_transition_reference``) draws the kernel's
own numbers. The torch Philox costs a few hundred small integer ops per
draw, so the samplers' plain paths do not use it: they draw from torch's
own generator, seeded per iteration
(:func:`iteration_generator`), as the JAX package's scan path draws from
``jax.random`` while its kernel uses the hardware PRNG.

A key is a pair of uint32 Python ints, drawn once from a
``torch.Generator`` (:func:`philox_key`). The Philox counter is
``(t, row, group, stream)``: the iteration, the chain (row), the group of 4
consecutive elements along the last axis, and the stream (0 for the MH
uniform, ``1 + i`` for the momentum of the i-th latent in sorted-name
order, ``0x100 + k`` for the NUTS kernel's uniforms: tree directions,
leaf selections and merge selections, ``0x200`` for the SGMCMC kernels'
integrator noise and ``0x201`` for the momentum that SGHMC and SGNHT
resample, ``0x300`` for the particle noise of the ADVI trainer, whose
iteration word is the optimisation step and whose row is the particle,
``0x400`` and ``0x401`` for the standalone normal and uniform samplers of
:mod:`.random`, whose iteration word is 0). Either way a loop over
iterations needs no host sync to draw. Streams differ from ``jax.random``
by design.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = [
    "STREAM_MH",
    "STREAM_MOMENTUM",
    "STREAM_NUTS_DIRECTION",
    "STREAM_NUTS_LEAF",
    "STREAM_NUTS_MERGE",
    "STREAM_SGMCMC_NOISE",
    "STREAM_SGMCMC_RESAMPLE",
    "STREAM_ADVI_NOISE",
    "STREAM_RANDOM_NORMAL",
    "STREAM_RANDOM_UNIFORM",
    "philox_key",
    "as_key",
    "iteration_generator",
    "child_key",
    "philox4x32_10",
    "uniform_from_bits",
    "split_boxmuller_normal",
    "philox_normal",
    "philox_uniform",
    "philox_uniform_rows",
]

STREAM_MH = 0
STREAM_MOMENTUM = 1  # + index of the latent in sorted-name order
STREAM_NUTS_DIRECTION = 0x100  # [chains, max_tree_depth]
STREAM_NUTS_LEAF = 0x101  # [chains, 2**max_tree_depth - 1]
STREAM_NUTS_MERGE = 0x102  # [chains, max_tree_depth]
STREAM_SGMCMC_NOISE = 0x200  # [chains, dim]: the integrator's N(0, 1)
STREAM_SGMCMC_RESAMPLE = 0x201  # [chains, dim]: a resampled momentum
STREAM_ADVI_NOISE = 0x300  # [n_particles, dim] per step: the ELBO particles
STREAM_RANDOM_NORMAL = 0x400  # [rows, cols]: ops/random.py::gpu_normal
STREAM_RANDOM_UNIFORM = 0x401  # [rows, cols]: ops/random.py::gpu_uniform

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 2.0 * math.pi

Key = Tuple[int, int]


def philox_key(generator: Optional[torch.Generator] = None) -> Key:
    """Draw a Philox key ``(k0, k1)`` of two uint32 ints from ``generator``.

    One draw per ``HMC.run``; with a CUDA generator this reads two numbers
    back from the card once.
    """
    device = generator.device if generator is not None else "cpu"
    k = torch.randint(0, 1 << 32, (2,), generator=generator,
                      dtype=torch.int64, device=device)
    k0, k1 = k.tolist()
    return int(k0), int(k1)


def as_key(key) -> Key:
    """A key ``(k0, k1)`` from a ``torch.Generator`` (one draw), a
    ``(k0, k1)`` pair, or None (the default CPU generator)."""
    if key is None or isinstance(key, torch.Generator):
        return philox_key(key)
    k0, k1 = key
    return int(k0), int(k1)


def _splitmix(key: Key, t: int, salt: int = -1) -> int:
    """The splitmix64 hash of ``(key, t)`` (and ``salt`` when >= 0)."""
    z = (((int(key[0]) & _MASK32) << 32) | (int(key[1]) & _MASK32))
    z = (z + (int(t) + 1) * 0x9E3779B97F4A7C15
         + (int(salt) + 1) * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def iteration_generator(key: Key, t: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for iteration ``t`` of the run
    keyed by ``key``: seeded with a splitmix64 hash of ``(key, t)`` on the
    host, so one key serves a whole run with no host sync and no state
    carried between iterations."""
    g = torch.Generator(device=device if device is not None else "cpu")
    g.manual_seed(_splitmix(key, t))
    return g


def child_key(key: Key, t: int, salt: int = 0) -> Key:
    """A key derived from ``(key, t, salt)`` on the host (the counterpart of
    ``jax.random.fold_in``): a run hands one to each of its sub-runs (an
    SMC temperature's moves, a PMMH iteration's filters) with no device
    draw."""
    z = _splitmix(key, t, salt)
    return z >> 32, z & _MASK32


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for int64 ``a`` in [0, 2^32),
    exact in int64 by splitting ``a`` into 16-bit halves."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    p_hi, p_lo = a_hi * m, a_lo * m  # each < 2^48
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 counter words.

    Returns four int64 tensors of uint32 output words, broadcast over the
    counter words' shapes.
    """
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits):
    """uint32 bits (held in int64) -> float32 uniforms in [0, 1).

    Sets the 23 mantissa bits with exponent 0, so the bit pattern is a
    float in [1, 2), then subtracts 1.
    """
    pattern = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return pattern.view(torch.float32) - 1.0


def split_boxmuller_normal(bits1, bits2):
    """Two float32 standard-normal tensors from two tensors of uint32 bits,
    using both Box-Muller outputs: ``(r cos theta, r sin theta)``."""
    u1 = torch.clamp(uniform_from_bits(bits1), min=1e-7)
    u2 = uniform_from_bits(bits2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _row_words(key: Key, t: int, shape, stream: int, device):
    """``(n_rows, n_cols, words)`` for ``shape`` laid out as the kernels
    draw it: the last axis is the column axis, every other axis is
    flattened into rows, and the counter ``(t, row, g, stream)`` gives the
    four words of columns ``4g .. 4g+3``."""
    shape = tuple(shape)
    n_cols = shape[-1] if shape else 1
    n_rows = math.prod(shape[:-1]) if shape else 1
    n_groups = -(-n_cols // 4)
    tt = torch.full((), t & _MASK32, dtype=torch.int64, device=device)
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)[:, None]
    groups = torch.arange(n_groups, dtype=torch.int64, device=device)[None]
    stream_w = torch.full((), stream, dtype=torch.int64, device=device)
    return n_rows, n_cols, philox4x32_10(tt, rows, groups, stream_w, *key)


def philox_normal(key: Key, t: int, shape, stream: int, device=None):
    """float32 standard normals of ``shape`` (layout of
    :func:`_row_words`; Box-Muller on words (0, 1) and (2, 3))."""
    n_rows, n_cols, (b0, b1, b2, b3) = _row_words(key, t, shape, stream,
                                                  device)
    n0, n1 = split_boxmuller_normal(b0, b1)
    n2, n3 = split_boxmuller_normal(b2, b3)
    out = torch.stack([n0, n1, n2, n3], dim=-1).reshape(n_rows, -1)
    return out[:, :n_cols].reshape(shape)


def philox_uniform_rows(key: Key, t: int, shape, stream: int, device=None):
    """float32 uniforms in [0, 1) of ``shape`` (layout of
    :func:`_row_words`: word ``j % 4`` of group ``j // 4`` is column
    ``j``), as the NUTS kernel draws its directions, leaf and merge
    selections."""
    n_rows, n_cols, words = _row_words(key, t, shape, stream, device)
    out = uniform_from_bits(torch.stack(words, dim=-1)).reshape(n_rows, -1)
    return out[:, :n_cols].reshape(shape)


def philox_uniform(key: Key, t: int, shape, stream: int = STREAM_MH,
                   device=None):
    """float32 uniforms in [0, 1) of ``shape``, one per flattened element:
    word 0 of the counter ``(t, element, 0, stream)`` (the HMC kernel's
    per-chain MH uniform)."""
    shape = tuple(shape)
    n = math.prod(shape) if shape else 1
    _, _, (b0, _, _, _) = _row_words(key, t, (n, 1), stream, device)
    return uniform_from_bits(b0).reshape(shape)
