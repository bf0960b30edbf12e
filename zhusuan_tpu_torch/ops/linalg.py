"""Cholesky factor and its inverse of a small SPD matrix: a hand-written
CUDA kernel, its plain version and a matmul-only gradient.

Replaces the Pallas TPU kernel ``zhusuan_tpu/ops/linalg.py::
_chol_inv_kernel`` (``pallas_call`` at :110; entry ``cholesky_inverse``):
``(L, L^{-1})`` of one ``[n, n]`` float32 symmetric positive-definite
matrix, n <= 512, in one launch (``csrc/linalg.cu``: one thread block, a
right-looking Cholesky that carries ``L^{-1}`` along, n dependent column
steps). With ``L^{-1}`` in hand every downstream triangular solve of the
sparse-GP step becomes a matmul, and the gradient below is matmuls only.

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

__all__ = ["cholesky_inverse", "cholesky_inverse_reference",
           "chol_inv_supported"]

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


def kernel_library():
    """Build (at first use) and load ``csrc/linalg.cu``; returns ``(cdll,
    build_record)`` (see :func:`._build.load_library`)."""
    from zhusuan_tpu_torch.ops._build import load_library

    lib, record = load_library("linalg")
    if not getattr(lib, "_zs_typed", False):
        ptr = ctypes.c_void_p
        lib.zs_cholesky_inverse.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr]
        lib.zs_cholesky_inverse.restype = ctypes.c_int
        lib.zs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zs_cuda_error_string.restype = ctypes.c_char_p
        lib._zs_typed = True
    return lib, record


def _launch(a):
    """``(L, L^{-1})`` by the kernel, for an eligible CUDA tensor."""
    n = a.shape[0]
    a = a.contiguous()
    l = torch.empty_like(a)
    linv = torch.empty_like(a)
    lib, _ = kernel_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.zs_cholesky_inverse(a.data_ptr(), n, l.data_ptr(),
                                     linv.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("cholesky_inverse launch failed: CUDA error {} "
                           "({}).".format(rc, lib.zs_cuda_error_string(rc)
                                          .decode()))
    cholesky_inverse.launches += 1
    return l, linv


def cholesky_inverse_reference(a):
    """Plain torch version: ``torch.linalg.cholesky_ex``, then
    ``solve_triangular(L, I)``, with the NaN pattern where the matrix is
    not positive definite (``info != 0``; no host sync). Takes ``[..., n,
    n]`` of any float dtype."""
    l, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    bad = (info != 0)[..., None, None]
    nan = torch.full_like(l, float("nan"))
    l = torch.where(bad, torch.tril(nan), l)
    linv = torch.where(bad, nan, linv)
    return l, linv


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
