"""Tests of zhusuan_tpu_torch/ops/linalg.py (the Cholesky-plus-inverse
kernel K10, its plain version and its matmul-only gradient) on the CPU.

Imports no jax, so its ``cuda`` tests also run on a GPU host:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_linalg.py``.
The plain version is held to numpy, the closed-form VJP to autograd
through ``torch.linalg``; the kernel's blocked recurrence
(``cholesky_inverse_panel_reference``) to the plain version, to the column
recurrence it reduces to at ``panel=1`` and, on the same numpy-seeded
matrix, to the JAX package's Pallas kernel in interpret mode; the CUDA
kernel to both plain versions on the card (the ``cuda`` tests below, and
``chip_smoke.py`` phase 14). The SVGP path's parity with the JAX package is
in ``tests/test_torch_svgp.py``. The ``cuda`` tests read jax only inside the
one test that needs it, so the file still runs on a GPU host without it.
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch.ops import linalg

torch.set_num_threads(1)

# tests/test_ops_linalg.py:37-43: the kernel's right-looking loop and a
# library's blocked factorization round differently, so L within 2e-5
# (rtol and atol), L^{-1} within 3e-4, L L^{-1} = I within 5e-5.
L_TOL, LINV_TOL, EYE_TOL = 2e-5, 3e-4, 5e-5
GRAD_TOL = 2e-4  # tests/test_ops_linalg.py:100-102


def _spd(n, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    b = rng.randn(n, 4 * n).astype(dtype)
    return b @ b.T / (4 * n) + np.eye(n, dtype=dtype)


def _crowded_gram(n, seed=0):
    """SVGP's inducing Gram matrix (RBF at scale softplus(0) = log 2) of
    points drawn close together in 13 dimensions, + 1e-6 I (cond ~4e3 at
    n = 100)."""
    z = 0.2 * np.random.RandomState(seed).randn(n, 13)
    d2 = ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1)
    return (np.exp(-0.5 * d2 / np.log(2.0)) + 1e-6 * np.eye(n)).astype(
        np.float32)


def _not_spd(n):
    a = np.eye(n, dtype=np.float32)
    a[n // 2, n // 2] = -1.0
    return a


@pytest.mark.parametrize("n", [3, 17, 100])
def test_plain_version_matches_numpy(n):
    a = _spd(n, seed=n)
    l, linv = linalg.cholesky_inverse(torch.as_tensor(a))
    l_ref = np.linalg.cholesky(a.astype(np.float64))
    linv_ref = np.linalg.inv(l_ref)
    np.testing.assert_allclose(l.numpy(), l_ref, rtol=L_TOL, atol=L_TOL)
    np.testing.assert_allclose(linv.numpy(), linv_ref, rtol=LINV_TOL,
                               atol=LINV_TOL)
    np.testing.assert_allclose(l.double().numpy() @ linv.double().numpy(),
                               np.eye(n), atol=EYE_TOL)


def test_float64_on_the_plain_version_is_exact():
    a = _spd(8, seed=5, dtype=np.float64)
    l, linv = linalg.cholesky_inverse(torch.as_tensor(a))
    np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), rtol=1e-12)
    np.testing.assert_allclose(l.numpy() @ linv.numpy(), np.eye(8),
                               atol=1e-12)


def test_strict_triangularity():
    l, linv = linalg.cholesky_inverse(torch.as_tensor(_spd(12, seed=3)))
    assert (torch.triu(l, 1) == 0).all()
    assert (torch.triu(linv, 1) == 0).all()


@pytest.mark.parametrize("n", [4, 100])
def test_not_positive_definite_gives_the_nan_pattern(n):
    """L is NaN on and below the diagonal and 0 above it, L^{-1} NaN
    everywhere: the JAX package's reference path (cholesky, then a
    triangular solve) gives this, with no exception and no host sync."""
    l, linv = linalg.cholesky_inverse(torch.as_tensor(_not_spd(n)))
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    assert torch.isnan(l[lower]).all()
    assert (l[~lower] == 0).all()
    assert torch.isnan(linv).all()


# --------------------------------------------------------------------- #
# The blocked recurrence the kernel runs, in plain torch
# --------------------------------------------------------------------- #
# Every size around a seam of the kernel (a 16-column panel, one block's
# largest size 304, 338/339) with every panel width; the large sizes at the
# kernel's own width only, to stay fast.
PANEL_CASES = ([(n, panel) for n in (1, 3, 16, 17, 32, 33, 100)
                for panel in (1, 16, 32)]
               + [(n, 16) for n in (304, 305, 338, 339, 512)])


@pytest.mark.parametrize("n,panel", PANEL_CASES)
def test_panel_recurrence_matches_plain_version(n, panel):
    a64 = _spd(n, seed=n, dtype=np.float64)
    l, linv = linalg.cholesky_inverse_panel_reference(
        torch.as_tensor(a64), panel)
    l_ref, linv_ref = linalg.cholesky_inverse_reference(torch.as_tensor(a64))
    np.testing.assert_allclose(l.numpy(), l_ref.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(linv.numpy(), linv_ref.numpy(), rtol=1e-10,
                               atol=1e-10)
    a32 = torch.as_tensor(a64.astype(np.float32))
    l, linv = linalg.cholesky_inverse_panel_reference(a32, panel)
    assert l.dtype == torch.float32
    l_ref, linv_ref = linalg.cholesky_inverse_reference(a32)
    np.testing.assert_allclose(l.numpy(), l_ref.numpy(), rtol=L_TOL,
                               atol=L_TOL)
    np.testing.assert_allclose(linv.numpy(), linv_ref.numpy(),
                               rtol=LINV_TOL, atol=LINV_TOL)
    assert (torch.triu(l, 1) == 0).all() and (torch.triu(linv, 1) == 0).all()


def _column_recurrence(a):
    """The kernel's first version, written out: column j scales row j of
    the running inverse and column j of the Schur complement by ``1 / d``
    into ``v`` and takes the rank-1 update ``W[i][e] -= v_i v_e`` of every
    row below."""
    n = a.shape[0]
    w = np.tril(a).copy()
    l = np.zeros_like(w)
    for j in range(n):
        d = np.sqrt(w[j, j])
        inv = 1.0 / d
        v = np.concatenate([w[j, :j] * inv, [inv], w[j + 1:, j] * inv])
        l[j, j], l[j + 1:, j] = d, v[j + 1:]
        for i in range(j + 1, n):
            w[i, j] = 0.0
            w[i, :i + 1] -= v[i] * v[:i + 1]
        w[j, :j + 1] = v[:j + 1]
    return l, w


@pytest.mark.parametrize("n", [1, 3, 17, 40])
def test_panel_of_one_is_the_column_recurrence(n):
    a = _spd(n, seed=n, dtype=np.float64)
    l, linv = linalg.cholesky_inverse_panel_reference(torch.as_tensor(a), 1)
    l_col, linv_col = _column_recurrence(a)
    np.testing.assert_allclose(l.numpy(), l_col, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(linv.numpy(), linv_col, rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("where", ["first", "middle", "ragged_last"])
@pytest.mark.parametrize("n,panel", [(40, 16), (100, 16), (100, 32), (7, 1)])
def test_panel_recurrence_nan_pattern(n, panel, where):
    """A bad pivot in the first panel, a middle one and the ragged last one
    (n is no multiple of the panel) gives the plain version's pattern."""
    j = {"first": 0, "middle": n // 2, "ragged_last": n - 1}[where]
    a = _spd(n, seed=n)
    a[j, j] = -1.0
    a = torch.as_tensor(a)
    l, linv = linalg.cholesky_inverse_panel_reference(a, panel)
    l_ref, linv_ref = linalg.cholesky_inverse_reference(a)
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    assert torch.isnan(l[lower]).all() and (l[~lower] == 0).all()
    assert torch.isnan(linv).all()
    for got, want in ((l, l_ref), (linv, linv_ref)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


def test_panel_recurrence_rejects_bad_arguments():
    with pytest.raises(ValueError, match=r"\[n, n\]"):
        linalg.cholesky_inverse_panel_reference(torch.ones(3, 4))
    with pytest.raises(ValueError, match="panel"):
        linalg.cholesky_inverse_panel_reference(torch.eye(3), 0)


@pytest.mark.parametrize("n", [17, 100])
@pytest.mark.parametrize("matrix", ["spd", "crowded"])
def test_panel_recurrence_matches_the_pallas_kernel(n, matrix, monkeypatch):
    """The same numpy-seeded matrix through the JAX package's K10 (the
    Pallas kernel in interpret mode) and the panel recurrence, float32.
    The Pallas kernel walks single columns and rewrites the whole matrix
    with masks, the panel recurrence sums 16 columns at a time: L within
    1e-4 and L^{-1} within 3e-3 (rtol and atol), ten times the tolerances
    between two float32 factorizations of the well-conditioned matrix, for
    the crowded Gram matrix's condition number of ~4e3."""
    import jax.numpy as jnp

    from zhusuan_tpu.ops import linalg as zlin

    monkeypatch.setattr(zlin, "_FORCE_INTERPRET", True)
    a = _spd(n, seed=n) if matrix == "spd" else _crowded_gram(n, seed=n)
    assert zlin.chol_inv_supported(n, jnp.float32)
    l_jax, linv_jax = zlin.cholesky_inverse(jnp.asarray(a))
    l, linv = linalg.cholesky_inverse_panel_reference(torch.as_tensor(a), 16)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_jax), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(linv.numpy(), np.asarray(linv_jax), rtol=3e-3,
                               atol=3e-3)


def test_layouts_that_hold_a_size():
    """One block holds up to n = 304 (19 panels), a cluster of 2 up to 416,
    3 and more the whole gate."""
    largest = {b: max(n for n in range(1, 513) if linalg.layout_fits(n, b))
               for b in range(1, 9)}
    assert largest == {1: 304, 2: 416, 3: 512, 4: 512, 5: 512, 6: 512,
                       7: 512, 8: 512}
    assert not linalg.layout_fits(100, 0) and not linalg.layout_fits(100, 9)
    assert not linalg.layout_fits(513, 8)


def test_supported_gate():
    assert linalg.chol_inv_supported(100, torch.float32)
    assert linalg.chol_inv_supported(512, torch.float32)
    assert not linalg.chol_inv_supported(1024, torch.float32)
    assert not linalg.chol_inv_supported(100, torch.float64)


def test_cpu_tensors_never_launch():
    before = linalg.cholesky_inverse.launches
    linalg.cholesky_inverse(torch.as_tensor(_spd(5)))
    assert linalg.cholesky_inverse.launches == before


def _loss(n, seed, fused, w_l, w_linv, dtype=torch.float32, device="cpu"):
    """A scalar through B -> B B^T + I touching L and/or L^{-1} with fixed
    random weights (tests/test_ops_linalg.py:68-90)."""
    rng = np.random.RandomState(seed)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    b0 = t(rng.randn(n, n) * 0.3)
    wl, wi = t(rng.randn(n, n)), t(rng.randn(n, n))
    eye = torch.eye(n, dtype=dtype, device=device)

    def f(b):
        a = b @ b.T + eye
        if fused:
            l, linv = linalg.cholesky_inverse(a)
        else:
            l = torch.linalg.cholesky(a)
            linv = torch.linalg.solve_triangular(l, eye, upper=False)
        return w_l * torch.sum(wl * l) + w_linv * torch.sum(wi * linv)

    return b0, f


def _grad(f, b0):
    b = b0.clone().requires_grad_(True)
    g, = torch.autograd.grad(f(b), b)
    return g


@pytest.mark.parametrize("w_l,w_linv", [(1.0, 0.0), (0.0, 1.0), (1.0, 1.0)])
def test_vjp_matches_autograd_through_torch_linalg(w_l, w_linv):
    b0, f_fused = _loss(9, 11, True, w_l, w_linv, torch.float64)
    _, f_ref = _loss(9, 11, False, w_l, w_linv, torch.float64)
    np.testing.assert_allclose(_grad(f_fused, b0).numpy(),
                               _grad(f_ref, b0).numpy(), rtol=1e-10,
                               atol=1e-10)
    b0, f_fused = _loss(9, 11, True, w_l, w_linv)
    _, f_ref = _loss(9, 11, False, w_l, w_linv)
    np.testing.assert_allclose(_grad(f_fused, b0).numpy(),
                               _grad(f_ref, b0).numpy(), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


# --------------------------------------------------------------------- #
# On the card: the kernel against its plain version
# --------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 16, 17, 32, 33, 100, 112, 113, 256,
                               304, 305, 338, 339, 512])
@pytest.mark.parametrize("matrix", ["spd", "crowded"])
def test_kernel_matches_plain_version(n, matrix):
    dev = _cuda()
    a_np = _spd(n, seed=n) if matrix == "spd" else _crowded_gram(n, seed=n)
    a = torch.as_tensor(a_np, device=dev)
    before = linalg.cholesky_inverse.launches
    l, linv = linalg.cholesky_inverse(a)
    lp, linvp = linalg.cholesky_inverse_reference(a)
    torch.cuda.synchronize()
    assert linalg.cholesky_inverse.launches == before + 1
    if matrix == "spd" or n <= 100:
        np.testing.assert_allclose(l.cpu().numpy(), lp.cpu().numpy(),
                                   rtol=L_TOL, atol=L_TOL)
        np.testing.assert_allclose(linv.cpu().numpy(), linvp.cpu().numpy(),
                                   rtol=LINV_TOL, atol=LINV_TOL)
    else:
        # cond(A) > 1e4: two float32 factorizations differ entrywise by up
        # to cond(A) x eps, so hold the kernel's backward error instead.
        l64 = l.double()
        np.testing.assert_allclose((l64 @ l64.T).cpu().numpy(),
                                   a.double().cpu().numpy(), rtol=0,
                                   atol=L_TOL)
    assert (torch.triu(l, 1) == 0).all() and (torch.triu(linv, 1) == 0).all()
    eye = l.double() @ linv.double()
    np.testing.assert_allclose(eye.cpu().numpy(), np.eye(n), atol=EYE_TOL)


def _layouts(n):
    """Thread blocks per launch whose shared memory holds size n."""
    return [b for b in (1, 2, 4, 8) if linalg.layout_fits(n, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 17, 33, 100, 113, 304, 305, 339, 512])
def test_kernel_matches_panel_recurrence_on_every_layout(n):
    """Entrywise, at the tolerances two float32 factorizations of this
    well-conditioned matrix are held to: the kernel and the plain panel
    recurrence differ only in the order of the rank-16 update's sums and
    in FMA contraction."""
    dev = _cuda()
    a = torch.as_tensor(_spd(n, seed=n), device=dev)
    lp, linvp = linalg.cholesky_inverse_panel_reference(a, 16)
    for blocks in [0] + _layouts(n):
        before = linalg.cholesky_inverse.launches
        l, linv = linalg._launch(a, blocks)
        torch.cuda.synchronize()
        assert linalg.cholesky_inverse.launches == before + 1
        np.testing.assert_allclose(l.cpu().numpy(), lp.cpu().numpy(),
                                   rtol=L_TOL, atol=L_TOL)
        np.testing.assert_allclose(linv.cpu().numpy(), linvp.cpu().numpy(),
                                   rtol=LINV_TOL, atol=LINV_TOL)
        assert (torch.triu(l, 1) == 0).all()
        assert (torch.triu(linv, 1) == 0).all()


@pytest.mark.cuda
def test_one_block_refuses_what_it_cannot_hold():
    dev = _cuda()
    a = torch.as_tensor(_spd(305, seed=1), device=dev)
    before = linalg.cholesky_inverse.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        linalg._launch(a, 1)
    assert linalg.cholesky_inverse.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 33, 100, 305, 512])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_kernel_nan_pattern_matches_plain_version(n, where):
    dev = _cuda()
    j = {"first": 0, "middle": n // 2, "last": n - 1}[where]
    bad = _spd(n, seed=n)
    bad[j, j] = -1.0
    for a_np in (bad, _not_spd(n)):
        a = torch.as_tensor(a_np, device=dev)
        lp, linvp = linalg.cholesky_inverse_reference(a)
        for blocks in [0] + _layouts(n):
            l, linv = linalg._launch(a, blocks)
            for got, want in ((l, lp), (linv, linvp)):
                assert torch.equal(torch.isnan(got), torch.isnan(want))
                assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 100])
def test_kernel_vjp_matches_autograd(n):
    dev = _cuda()
    for w_l, w_linv in ((1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        b0, f_fused = _loss(n, 11, True, w_l, w_linv, device=dev)
        _, f_ref = _loss(n, 11, False, w_l, w_linv, device=dev)
        np.testing.assert_allclose(_grad(f_fused, b0).cpu().numpy(),
                                   _grad(f_ref, b0).cpu().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
def test_ineligible_cuda_inputs_take_the_plain_version():
    dev = _cuda()
    before = linalg.cholesky_inverse.launches
    a64 = torch.as_tensor(_spd(8, dtype=np.float64), device=dev)
    l, _ = linalg.cholesky_inverse(a64)
    big = torch.as_tensor(_spd(600, seed=1), device=dev)
    lb, linvb = linalg.cholesky_inverse(big)
    torch.cuda.synchronize()
    assert linalg.cholesky_inverse.launches == before
    assert l.dtype == torch.float64 and torch.isfinite(lb).all()
