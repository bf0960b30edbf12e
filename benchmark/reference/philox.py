"""Philox4x32-10 (Salmon et al., SC'11) in plain torch, and the draws the
kernels under test make from it.

The sampled kernels draw their noise from Philox4x32-10 keyed by a pair of
32-bit words and counted by ``(iteration, row, group of 4 columns,
stream)``; a column ``j`` of a row takes word ``j % 4`` of group ``j // 4``.
A uniform is the word's top 23 bits as a fraction in [0, 1); a normal is
Box-Muller on words (0, 1) and (2, 3) of a group, ``(r cos, r sin)`` of
each pair, with the first uniform of a pair clamped to float32 ``1e-7``.
The normals are computed here in float64 from the same words, so they
differ from the kernels' float32 ones by float32 rounding only.

The seeds of the samplers' host-side step-size search come from a
splitmix64 hash of ``(key, iteration)`` (:func:`splitmix`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

STREAM_MH = 0
STREAM_MOMENTUM = 1
STREAM_NUTS_DIRECTION = 0x100
STREAM_NUTS_LEAF = 0x101
STREAM_NUTS_MERGE = 0x102

_CLAMP = float(np.float32(1e-7))


def splitmix(key, t: int) -> int:
    """splitmix64 of the key's 64 bits plus ``(t + 1)`` times the golden
    ratio, the seed of iteration ``t``'s
    host-side generator."""
    z = ((int(key[0]) & MASK32) << 32) | (int(key[1]) & MASK32)
    z = (z + (int(t) + 1) * 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def _mul_hi_lo(a, m: int):
    """High and low 32-bit words of ``a * m`` (``a`` int64 holding uint32
    values), exact in int64 through 16-bit halves of ``a``."""
    big = (a >> 16) * m
    small = (a & 0xFFFF) * m
    lo = (((big & 0xFFFF) << 16) + small) & MASK32
    hi = (big + (small >> 16)) >> 16
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 tensors of uint32 counter words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = int(k0) & MASK32, int(k1) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mul_hi_lo(c0, _M0)
        hi1, lo1 = _mul_hi_lo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(key, t: int, rows: int, groups: int, stream: int, device):
    i64 = dict(dtype=torch.int64, device=device)
    return philox(torch.full((), int(t) & MASK32, **i64),
                  torch.arange(rows, **i64)[:, None],
                  torch.arange(groups, **i64)[None],
                  torch.full((), stream, **i64), *key)


def _unit(bits, dtype):
    return (bits >> 9).to(dtype) * 2.0 ** -23


def normals(key, t: int, rows: int, cols: int, stream: int = STREAM_MOMENTUM,
            device=None, dtype=torch.float64):
    """``[rows, cols]`` standard normals of iteration ``t``."""
    b0, b1, b2, b3 = _words(key, t, rows, -(-cols // 4), stream, device)
    out = []
    for ba, bb in ((b0, b1), (b2, b3)):
        u1 = torch.clamp(_unit(ba, torch.float64), min=_CLAMP)
        theta = 2.0 * math.pi * _unit(bb, torch.float64)
        r = torch.sqrt(-2.0 * torch.log(u1))
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    z = torch.stack(out, dim=-1).reshape(rows, -1)[:, :cols]
    return z.to(dtype)


def uniform_rows(key, t: int, rows: int, cols: int, stream: int,
                 device=None):
    """``[rows, cols]`` uniforms of iteration ``t``, column ``j`` word
    ``j % 4`` of group ``j // 4`` (float64; exact float32 values)."""
    words = _words(key, t, rows, -(-cols // 4), stream, device)
    u = _unit(torch.stack(words, dim=-1), torch.float64)
    return u.reshape(rows, -1)[:, :cols]


def mh_uniforms(key, t: int, rows: int, device=None):
    """``[rows]`` Metropolis uniforms: word 0 of ``(t, row, 0, STREAM_MH)``."""
    b0, _, _, _ = _words(key, t, rows, 1, STREAM_MH, device)
    return _unit(b0[:, 0], torch.float64)
