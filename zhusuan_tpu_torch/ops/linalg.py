"""Cholesky factor and its inverse of a small SPD matrix: a hand-written
CUDA kernel, its plain version and a matmul-only gradient.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/linalg.py::
_chol_inv_kernel`` (``pallas_call`` at :110; entry ``cholesky_inverse``):
``(L, L^{-1})`` of one ``[n, n]`` float32 symmetric positive-definite
matrix, n <= 512, in one launch (``csrc/linalg.cu``: a right-looking
Cholesky that carries ``L^{-1}`` along, blocked into panels of 16 columns,
on one thread block or one thread block cluster).
:func:`cholesky_inverse_panel_reference` is that recurrence in plain torch.
With ``L^{-1}`` in hand every downstream triangular solve of the sparse-GP
step becomes a matmul, and the gradient below is matmuls only.

Routing (the JAX gate's rule, ``ops/linalg.py:147-153``): a CPU tensor runs
:func:`cholesky_inverse_reference`; a CUDA tensor that
:func:`chol_inv_supported` takes (2-D, square, float32, n <= 512) launches
the kernel, and a failed build or launch raises; any other CUDA tensor
(float64, n > 512, a batch) runs the plain version, as it would in the JAX
package.

Non-SPD input gives ``L`` NaN on and below the diagonal (0 above) and
``L^{-1}`` NaN everywhere, on every route and with no host sync: the JAX
package's reference path gives this pattern. Raising instead would need a
sync on every training step; the TPU kernel's pivot clamp (finite garbage)
is not carried over.

Gradient (``_chol_inv_bwd``, ``ops/linalg.py:156-179``): with ``Y =
L^{-1}``, ``L_bar += -tril(Y^T Y_bar Y^T)``, then the Cholesky pullback
(Murray 2016) ``A_bar = 0.5 Y^T (Phi(L^T L_bar) + Phi(L^T L_bar)^T) Y``
(``Phi``: lower triangle, halved diagonal), symmetrised. It stays
``torch.matmul``, as the JAX package leaves it to XLA: the TPU kernel has
no backward kernel.
"""

from __future__ import annotations

import ctypes

import torch

from zhusuan_tpu_torch.ops._launch import launch_kernel

__all__ = ["cholesky_inverse", "cholesky_inverse_reference",
           "cholesky_inverse_panel_reference", "chol_inv_supported"]

# The largest n the kernel takes, as in the JAX package: above it a blocked
# library factorization is the right tool.
_MAX_N = 512


def chol_inv_supported(n: int, dtype) -> bool:
    """Whether the kernel takes an ``[n, n]`` matrix of ``dtype`` (float32,
    n <= 512)."""
    return bool(n <= _MAX_N and dtype == torch.float32)


def _use_kernel(a) -> bool:
    """Whether ``a`` goes to the kernel: a CUDA tensor that
    :func:`chol_inv_supported` takes, 2-D and square."""
    return (a.device.type == "cuda" and a.ndim == 2
            and a.shape[0] == a.shape[1]
            and chol_inv_supported(a.shape[0], a.dtype))


def layout_fits(n: int, blocks: int) -> bool:
    """Whether ``blocks`` thread blocks (1, or one cluster of 2-8) hold an
    ``[n, n]`` matrix in shared memory: ``csrc/linalg.cu``'s own rule
    (``shared_bytes``), for the tests and the measurements that walk the
    layouts. Block ``r`` keeps the 16-row panels ``P = r (mod blocks)``,
    ``(P + 1) 16 + 4`` floats a row, beside ``V`` (16 rows of ``T 16 + 4``)
    and ``L11`` (16 x 17); a block may have 232,448 bytes."""
    if not (1 <= blocks <= 8 and 1 <= n <= _MAX_N):
        return False
    t = -(-n // 16)
    panels = 0
    for rank in range(min(blocks, t)):
        nl = (t - rank + blocks - 1) // blocks
        panels = max(panels, 256 * (blocks * (nl * (nl - 1) // 2)
                                    + (rank + 1) * nl) + 64 * nl)
    return 4 * (16 * 17 + 16 * (16 * t + 4) + panels) <= 232448


def kernel_library():
    """Build (at first use) and load ``csrc/linalg.cu``; returns ``(cdll,
    build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("linalg")
    if not getattr(lib, "_zs_typed", False):
        ptr = ctypes.c_void_p
        lib.zs_cholesky_inverse.argtypes = [ptr, ctypes.c_int, ptr, ptr,
                                            ctypes.c_int, ptr]
        lib.zs_cholesky_inverse.restype = ctypes.c_int
        lib.zs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def _launch(a, blocks=0):
    """``(L, L^{-1})`` by the kernel, for an eligible CUDA tensor. ``blocks``
    (the measurements' and the tests' hook) is 1 for one thread block, 2-8
    for one cluster of that many, 0 for the kernel's own choice."""
    n = a.shape[0]
    a = a.contiguous()
    l = torch.empty_like(a)
    linv = torch.empty_like(a)
    launch_kernel(cholesky_inverse, kernel_library, "zs_cholesky_inverse",
                  a.device, a.data_ptr(), n, l.data_ptr(), linv.data_ptr(),
                  blocks, inputs=(a,), outputs=(l, linv))
    return l, linv


def cholesky_inverse_reference(a):
    """Plain torch version: ``torch.linalg.cholesky_ex``, then
    ``solve_triangular(L, I)``, with the NaN pattern where the matrix is
    not positive definite (``info != 0``, or a diagonal entry of ``L`` that
    is not finite: on the card the library leaves a bad last pivot of a
    matrix of 128 rows or more as a NaN with ``info == 0``; no host sync).
    Takes ``[..., n, n]`` of any float dtype."""
    l, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    diagonal = torch.diagonal(l, dim1=-2, dim2=-1)
    bad = ((info != 0) | ~torch.isfinite(diagonal).all(-1))[..., None, None]
    nan = torch.full_like(l, float("nan"))
    l = torch.where(bad, torch.tril(nan), l)
    linv = torch.where(bad, nan, linv)
    return l, linv


def _factor_diagonal_block(m):
    """``(L11, L11^{-1}, ok)`` of one ``[b, b]`` diagonal block by the column
    recurrence that carries the inverse along: at column k the pivot's row
    of the inverse is scaled by ``1 / d`` and eliminated from the rows
    below, beside the Schur update (the kernel's step 1; the kernel gets
    ``L11^{-1}`` by the same operations in its step 2, as the substitution
    run on the identity). ``ok`` is a 0-d bool tensor: every pivot positive
    and finite."""
    b = m.shape[0]
    t = torch.tril(m).clone()  # columns < k: the inverse; >= k: the block
    l = torch.zeros_like(m)
    ok = torch.ones((), dtype=torch.bool, device=m.device)
    for k in range(b):
        p = t[k, k]
        ok = ok & (p > 0) & torch.isfinite(p)
        d = torch.sqrt(p)
        inv = 1.0 / d
        v = torch.cat([t[k, :k] * inv, inv[None], t[k + 1:, k] * inv])
        l[k, k] = d
        l[k + 1:, k] = v[k + 1:]
        below = t[k + 1:].clone()
        below[:, k] = 0.0  # the inverse's column k was 0 below the pivot
        t[k + 1:] = torch.tril(below - torch.outer(v[k + 1:], v),
                               diagonal=k + 1)
        t[k, :k + 1] = v[:k + 1]
    return l, t, ok


def _forward_substitution(l11, x11, rhs):
    """Solves ``L11 X = rhs`` (``[b, b]``, ``[b, m]``) row by row, the
    reciprocals of the diagonal read from ``X11``'s: the kernel's step 2.
    (A product with ``X11`` has a residual of ``cond(L11) eps``, which on
    an inducing Gram matrix of condition 1e8 exceeds the jitter that keeps
    the later pivots positive.)"""
    out = rhs.clone()
    for q in range(l11.shape[0]):
        out[q] = out[q] * x11[q, q]
        out[q + 1:] = out[q + 1:] - torch.outer(l11[q + 1:, q], out[q])
    return out


def cholesky_inverse_panel_reference(a, panel=16):
    """Plain torch version of the kernel's blocked recurrence itself, for
    one ``[n, n]`` matrix of any float dtype: ONE lower-triangular working
    matrix ``W`` (columns left of the front hold the running ``L^{-1}``,
    columns from the front on the Schur complement) and, per panel ``J`` of
    ``panel`` columns with ``I`` the rows below it,

    1. the diagonal block: ``W_JJ = L11 L11^T``, ``X11 = L11^{-1}``
       (:func:`_factor_diagonal_block`; the pivot test happens here);
    2. the panel's rows by forward substitution
       (:func:`_forward_substitution`): ``L21 = W_IJ L11^{-T}``, and rows
       ``J`` of the inverse, ``L11^{-1} W_J,c<j0`` and ``X11``;
    3. one rank-``panel`` update of everything below: with ``V = [X_J |
       L21^T]``, ``W_I -= L21 V`` over the lower triangle (the panel's own
       columns start from 0), the panel's columns subtracted from ``W`` one
       after the other and not summed first: on a Gram matrix of crowded
       points the entries shrink by orders of magnitude along the panel and
       the roundings with them, where a sum of 16 products rounds 16 times
       at the entry's first size, enough to turn a pivot of 1e-6 negative
       in float32.

    ``panel=1`` is the column recurrence. The NaN pattern on a matrix that
    is not positive definite is :func:`cholesky_inverse_reference`'s. The
    CPU tests and ``chip_smoke.py`` hold the kernel's algebra to it; no
    path of the package calls it.
    """
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError("a must be [n, n]; got shape {}.".format(
            tuple(a.shape)))
    panel = int(panel)
    if panel < 1:
        raise ValueError("panel must be >= 1; got {}.".format(panel))
    n = a.shape[0]
    w = torch.tril(a).clone()
    l = torch.zeros_like(a)
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    for j0 in range(0, n, panel):
        j1 = min(j0 + panel, n)
        l11, x11, ok_block = _factor_diagonal_block(w[j0:j1, j0:j1])
        ok = ok & ok_block
        # L11 [X_J | L21^T] = [W_J,c<j0 | W_IJ^T]: one forward substitution
        # for all the columns left of the panel and all the rows below it.
        solved = _forward_substitution(
            l11, x11, torch.cat([w[j0:j1, :j0], w[j1:, j0:j1].mT], dim=1))
        x_j, l21 = solved[:, :j0], solved[:, j0:].mT
        l[j0:j1, j0:j1] = l11
        l[j1:, j0:j1] = l21
        v = torch.cat([x_j, x11, l21.mT], dim=1)
        below = w[j1:].clone()
        below[:, j0:j1] = 0.0
        for p in range(j1 - j0):  # in the kernel's order: see the note
            below = below - torch.outer(l21[:, p], v[p])
        w[j1:] = torch.tril(below, diagonal=j1)
        w[j0:j1, :j0] = x_j
        w[j0:j1, j0:j1] = x11
    nan = torch.full_like(l, float("nan"))
    return torch.where(ok, l, torch.tril(nan)), torch.where(ok, w, nan)


def _phi(x):
    """Lower triangle with halved diagonal (Cholesky-pullback helper)."""
    return torch.tril(x) - 0.5 * torch.diag_embed(
        torch.diagonal(x, dim1=-2, dim2=-1))


class _CholeskyInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        if _use_kernel(a):
            l, linv = _launch(a)
        else:
            l, linv = cholesky_inverse_reference(a)
        ctx.save_for_backward(l, linv)
        return l, linv

    @staticmethod
    def backward(ctx, dl, dlinv):
        l, linv = ctx.saved_tensors
        linv_t = linv.mT
        dl_total = dl - torch.tril(linv_t @ dlinv @ linv_t)
        p = _phi(l.mT @ dl_total)
        da = 0.5 * (linv_t @ (p + p.mT) @ linv)
        # A is symmetric: return the symmetric pullback.
        return 0.5 * (da + da.mT)


def cholesky_inverse(a):
    """``(L, L^{-1})`` of a symmetric positive-definite ``[n, n]`` matrix.

    On a CUDA tensor that :func:`chol_inv_supported` takes this launches the
    CUDA kernel (counted in ``cholesky_inverse.launches``) or raises; on the
    CPU, and for other CUDA tensors, it runs
    :func:`cholesky_inverse_reference`. Differentiable: the backward pass
    is the closed-form pullback in ``(L, L^{-1})``, matmuls only.
    """
    return _CholeskyInverse.apply(a)


cholesky_inverse.launches = 0
