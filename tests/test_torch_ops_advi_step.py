"""Tests of zhusuan_tpu_torch/ops/advi_step.py (the whole-fit mean-field ADVI
trainer K11 and its plain version) and of the built-in densities'
``value_and_grad``, on the CPU.

Imports no jax, so its ``cuda`` tests also run on a GPU host:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_advi_step.py``.
On CPU tensors the wrapper runs the plain version, which is held here to
autograd (the gradient identity of ``tests/test_ops_advi.py:36-80``), to the
known optimum of a Gaussian target and to its gates and messages; the CUDA
kernel is held to the plain version on the card (the ``cuda`` tests below, and
``chip_smoke.py`` phase 17). The plain version against the JAX package's
Pallas kernel in interpret mode is in ``tests/test_torch_advi.py``.
"""

import math

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch import variational
from zhusuan_tpu_torch.ops import _random, advi_step, densities

torch.set_num_threads(1)

KEY = (0x0BADCAFE, 0x00C0FFEE)
_C = 0.5 * math.log(2.0 * math.pi)
# float64 runs against torch.optim.Adam: the trainer's [n_steps, 3] table is
# float32 (measured 1.2e-6 on a parameter after five steps of 0.03).
TABLE_TOL = 5e-6
MU0 = torch.tensor([2.0, -1.0])
SD0 = torch.tensor([0.5, 1.5])


def _density(kind, d, dtype=torch.float32, device="cpu"):
    if kind == "toy2d":
        return densities.Toy2DLogJoint("z")
    if kind == "diagonal":
        rng = np.random.RandomState(d)
        return densities.DiagonalGaussianLogJoint(
            "z", torch.as_tensor(rng.randn(d), dtype=dtype, device=device),
            torch.linspace(0.3, 1.5, d, dtype=dtype, device=device))
    return densities.EquicorrelatedGaussianLogJoint("z", d, 0.7)


CASES = [("toy2d", 2), ("diagonal", 5), ("diagonal", 37),
         ("equicorrelated", 7), ("equicorrelated", 100)]


# --------------------------------------------------------------------- #
# value_and_grad of the built-ins: autograd of log_prob, in float64 1e-12
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,d", CASES)
def test_value_and_grad_matches_autograd(kind, d):
    dens = _density(kind, d, torch.float64)
    x = torch.as_tensor(np.random.RandomState(1).randn(9, d),
                        dtype=torch.float64).requires_grad_(True)
    value, grad = dens.value_and_grad(x.detach())
    lp = dens.log_prob(x)
    (auto,) = torch.autograd.grad(lp.sum(), x)
    # Toy2D keeps float32-rounded constants: 1e-7 relative there.
    tol = 1e-12 if kind != "toy2d" else 1e-7
    np.testing.assert_allclose(value.numpy(), lp.detach().numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(grad.numpy(), auto.numpy(), rtol=tol, atol=tol)


def test_toy2d_is_the_two_node_log_joint():
    """log N(z2; 0, 1.35) + log N(z1; 0, exp(z2)), constants included."""
    dens = densities.Toy2DLogJoint("z", 1.35)
    z = torch.as_tensor(np.random.RandomState(2).randn(50, 2))
    z1, z2 = z[:, 0], z[:, 1]
    want = (torch.distributions.Normal(0.0, 1.35).log_prob(z2)
            + torch.distributions.Normal(0.0, torch.exp(z2)).log_prob(z1))
    np.testing.assert_allclose(dens.log_prob(z).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert dens({"z": z}).shape == (50,)
    with pytest.raises(ValueError, match="scale must be positive"):
        densities.Toy2DLogJoint("z", 0.0)


# --------------------------------------------------------------------- #
# The gradient identity (tests/test_ops_advi.py:36-80), by autograd
# --------------------------------------------------------------------- #
def test_formulas_match_sgvb_autograd():
    """Same eps => one step of the trainer moves the parameters as Adam on
    autograd's gradient of the library's own sgvb loss does, and reports
    that loss."""
    n, d = 64, 2
    dens = densities.DiagonalGaussianLogJoint("z", MU0.double(),
                                              SD0.double())
    eps = torch.as_tensor(np.random.RandomState(3).randn(1, n, d))
    loc = torch.tensor([0.3, -0.2], dtype=torch.float64, requires_grad=True)
    ls = torch.tensor([-0.5, 0.1], dtype=torch.float64, requires_grad=True)
    z = loc + torch.exp(ls) * eps[0]
    logq = torch.sum(-0.5 * eps[0] * eps[0] - _C - ls, dim=-1)
    loss = variational.elbo(dens, {}, latent={"z": (z, logq)},
                            axis=0).sgvb()
    loss.backward()
    opt = torch.optim.Adam([loc, ls], lr=0.05)
    opt.step()
    got_loc, got_ls, losses = advi_step.fused_meanfield_advi(
        dens, torch.tensor([0.3, -0.2], dtype=torch.float64),
        torch.tensor([-0.5, 0.1], dtype=torch.float64), 1, n, None,
        lambda t: 0.05, noise=eps)
    np.testing.assert_allclose(float(losses[0]), float(loss.detach()),
                               rtol=1e-12)
    # The trainer reads lr_t, c1 and c2 from its float32 table (c2 = 1 -
    # 0.999^t carries ~6e-5 relative there, as in the JAX kernel's float32
    # arithmetic), so a step of 0.05 agrees to ~1e-6, not to 1e-12.
    np.testing.assert_allclose(got_loc.numpy(), loc.detach().numpy(),
                               rtol=TABLE_TOL, atol=TABLE_TOL)
    np.testing.assert_allclose(got_ls.numpy(), ls.detach().numpy(),
                               rtol=TABLE_TOL, atol=TABLE_TOL)


@pytest.mark.parametrize("kind,d", CASES)
def test_five_steps_match_autograd_adam(kind, d):
    """Five chained steps in float64 against autograd + torch.optim.Adam on
    the sgvb loss of the same injected noise, at TABLE_TOL (the losses, sums
    over up to 100 columns of parameters that far apart, at four times it)."""
    n, steps = 8, 5
    dens = _density(kind, d, torch.float64)
    noise = torch.as_tensor(np.random.RandomState(4).randn(steps, n, d))
    loc0 = torch.full((d,), 0.1, dtype=torch.float64)
    ls0 = torch.full((d,), -1.0, dtype=torch.float64)
    loc = loc0.clone().requires_grad_(True)
    ls = ls0.clone().requires_grad_(True)
    opt = torch.optim.Adam([loc, ls], lr=0.03)
    want_losses = []
    for t in range(steps):
        opt.zero_grad()
        z = loc + torch.exp(ls) * noise[t]
        logq = torch.sum(-0.5 * noise[t] ** 2 - _C - ls, dim=-1)
        loss = variational.elbo(dens, {}, latent={"z": (z, logq)},
                                axis=0).sgvb()
        loss.backward()
        opt.step()
        want_losses.append(float(loss))
    got = advi_step.fused_meanfield_advi_reference(
        dens, loc0, ls0, steps, n, None, lambda t: 0.03, noise=noise)
    tol = TABLE_TOL
    np.testing.assert_allclose(got[0].numpy(), loc.detach().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got[1].numpy(), ls.detach().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got[2].numpy(), want_losses, rtol=4 * tol,
                               atol=4 * tol)


# --------------------------------------------------------------------- #
# The known optimum (tests/test_ops_advi.py:148-173)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("source", ["philox", "injected"])
def test_fit_reaches_known_optimum(source):
    n_steps, n = 500, 64
    dens = densities.DiagonalGaussianLogJoint("z", MU0, SD0)
    noise = None
    if source == "injected":
        noise = torch.as_tensor(
            np.random.RandomState(11).randn(n_steps, n, 2), dtype=torch.float32)
    loc, ls, losses = advi_step.fused_meanfield_advi(
        dens, torch.zeros(2), torch.zeros(2), n_steps, n, KEY,
        lambda t: 0.05, noise=noise)
    # The ELBO optimum of a Gaussian target is exact: q == p.
    np.testing.assert_allclose(loc.numpy(), MU0.numpy(), atol=0.12)
    np.testing.assert_allclose(torch.exp(ls).numpy(), SD0.numpy(), rtol=0.12)
    losses = losses.numpy()
    assert losses.shape == (n_steps,) and np.all(np.isfinite(losses))
    assert losses[-50:].mean() < losses[:10].mean()
    # The built-in omits its normalising constant: at q == p the loss is
    # -sum(log sd) - d 0.5 log(2 pi), not 0.
    exact = -float(torch.log(SD0).sum()) - 2 * _C
    assert abs(losses[-50:].mean() - exact) < 0.2, losses[-50:].mean()


def test_toy2d_fit_from_the_examples_init():
    """300 steps of the toy2d recipe: finite, the loss falls from ~13 to
    below 1.5 (the converged value is ~0.78)."""
    loc, ls, losses = advi_step.fused_meanfield_advi(
        densities.Toy2DLogJoint("z"), torch.full((2,), -2.0),
        torch.full((2,), -5.0), 300, 500, KEY, lambda t: 0.1)
    assert torch.isfinite(losses).all()
    assert 12.0 < float(losses[:50].mean()) < 14.0
    assert float(losses[-50:].mean()) < 1.5
    assert loc.shape == ls.shape == (2,)


# --------------------------------------------------------------------- #
# Noise, the schedule table, gates and messages
# --------------------------------------------------------------------- #
def test_own_draws_are_the_advi_stream():
    """The plain version's own draws are Philox (step, row, group,
    STREAM_ADVI_NOISE): injecting them reproduces the fit bit for bit, and
    another stream or key does not."""
    dens = _density("diagonal", 5)
    loc0, ls0 = torch.zeros(5), torch.full((5,), -1.0)
    own = advi_step.fused_meanfield_advi(dens, loc0, ls0, 6, 7, KEY,
                                         lambda t: 0.05)
    noise = torch.stack([_random.philox_normal(
        KEY, t, (7, 5), _random.STREAM_ADVI_NOISE, "cpu") for t in range(6)])
    injected = advi_step.fused_meanfield_advi(dens, loc0, ls0, 6, 7, None,
                                              lambda t: 0.05, noise=noise)
    for a, b in zip(own, injected):
        assert torch.equal(a, b)
    other = torch.stack([_random.philox_normal(
        KEY, t, (7, 5), _random.STREAM_SGMCMC_NOISE, "cpu") for t in range(6)])
    assert not torch.equal(noise, other)
    again = advi_step.fused_meanfield_advi(dens, loc0, ls0, 6, 7, (1, 2),
                                           lambda t: 0.05)
    assert not torch.equal(own[2], again[2])
    assert _random.STREAM_ADVI_NOISE == 0x300


def test_schedule_table():
    sched = variational.cosine_decay_schedule(1e-2, 50, 0.1)
    table = advi_step.schedule_table(sched, 50, 0.9, 0.999)
    assert table.shape == (50, 3) and table.dtype == torch.float32
    t = np.arange(50)
    np.testing.assert_allclose(table[:, 0].numpy(),
                               [sched(float(i)) for i in t], rtol=1e-7)
    np.testing.assert_allclose(table[:, 1].numpy(), 1 - 0.9 ** (t + 1),
                               rtol=1e-5)
    np.testing.assert_allclose(table[:, 2].numpy(), 1 - 0.999 ** (t + 1),
                               rtol=1e-4)


def test_gate():
    ok = advi_step.advi_step_supported
    assert ok(2, 500, 16000)  # the toy2d recipe (tests/test_ops_advi.py:187)
    assert ok(2, 33, 10)  # odd particle counts are fine on this card
    assert ok(2, 1, 1)
    assert not ok(0, 32, 10)
    assert not ok(2, 32, 0)
    assert not ok(2, 0, 10)
    assert not ok(513, 4, 10)  # past the kernel's widest instantiation
    assert ok(512, 512, 10)
    assert not ok(512, 513, 10)  # particle block past 1 MB
    assert not ok(4096, 4096, 10)
    assert not ok(2, 32, 2 ** 20 + 1)


def test_validation_messages():
    dens = _density("diagonal", 2)
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="unsupported size"):
        advi_step.fused_meanfield_advi(dens, z, z, 0, 4, KEY, lambda t: 0.1)
    with pytest.raises(ValueError, match="noise must have shape"):
        advi_step.fused_meanfield_advi(dens, z, z, 10, 4, KEY,
                                       lambda t: 0.1,
                                       noise=torch.zeros(10, 4, 3))
    with pytest.raises(ValueError, match="1-D tensors of one shape"):
        advi_step.fused_meanfield_advi(dens, z, torch.zeros(3), 10, 4, KEY,
                                       lambda t: 0.1)
    with pytest.raises(TypeError, match="only the built-in densities"):
        advi_step.fused_meanfield_advi(lambda obs: obs["z"].sum(-1), z, z,
                                       10, 4, KEY, lambda t: 0.1)
    with pytest.raises(ValueError):  # the density's dim differs
        advi_step.fused_meanfield_advi(_density("diagonal", 3), z, z, 10, 4,
                                       KEY, lambda t: 0.1)
    assert advi_step.DENSITIES == (densities.DiagonalGaussianLogJoint,
                                   densities.EquicorrelatedGaussianLogJoint,
                                   densities.Toy2DLogJoint)


def test_cpu_tensors_do_not_count_as_launches():
    before = advi_step.fused_meanfield_advi.launches
    advi_step.fused_meanfield_advi(_density("diagonal", 2), torch.zeros(2),
                                   torch.zeros(2), 2, 4, KEY, lambda t: 0.1)
    assert advi_step.fused_meanfield_advi.launches == before


def test_non_finite_fit_stays_non_finite():
    """z2 near -60 overflows exp(-2 z2) in float32: no guard, as in the JAX
    kernel."""
    _, _, losses = advi_step.fused_meanfield_advi(
        densities.Toy2DLogJoint("z"), torch.tensor([1.0, -60.0]),
        torch.full((2,), -5.0), 3, 16, KEY, lambda t: 0.1)
    assert not torch.isfinite(losses).all()


# --------------------------------------------------------------------- #
# On the card: the kernel against the plain version
# --------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d,n", [
    ("toy2d", 2, 500), ("diagonal", 100, 32), ("equicorrelated", 37, 7),
    ("diagonal", 200, 5), ("equicorrelated", 400, 3),
    ("diagonal", 3, 1500), ("equicorrelated", 4, 33),
    # more rows than the block has warps (32; 16 above 256 columns): a warp
    # sums several rows
    ("diagonal", 100, 64), ("equicorrelated", 37, 75), ("diagonal", 200, 70),
    ("equicorrelated", 400, 40), ("diagonal", 400, 21)])
@pytest.mark.parametrize("source", ["philox", "injected"])
def test_kernel_matches_plain_version_bit_for_bit(kind, d, n, source):
    dev = _cuda()
    dens = _density(kind, d, device=dev)
    loc0 = torch.zeros(d, device=dev)
    ls0 = torch.full((d,), math.log(0.1), device=dev)
    if kind == "toy2d":
        loc0, ls0 = loc0 - 2.0, torch.full((d,), -5.0, device=dev)
    noise = None
    if source == "injected":
        g = torch.Generator(device=dev).manual_seed(d)
        noise = torch.randn(10, n, d, generator=g, device=dev)
    before = advi_step.fused_meanfield_advi.launches
    got = advi_step.fused_meanfield_advi(dens, loc0, ls0, 10, n, KEY,
                                         lambda t: 0.05, noise=noise)
    assert advi_step.fused_meanfield_advi.launches == before + 1
    want = advi_step.fused_meanfield_advi_reference(
        dens, loc0, ls0, 10, n, KEY, lambda t: 0.05, noise=noise)
    torch.cuda.synchronize()
    for name, a, b in zip(("loc", "log_scale", "losses"), got, want):
        assert int((a != b).sum()) == 0, name


@pytest.mark.cuda
def test_kernel_raises_on_other_dtypes():
    dev = _cuda()
    dens = _density("diagonal", 4, torch.float64, dev)
    z = torch.zeros(4, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        advi_step.fused_meanfield_advi(dens, z, z, 2, 4, KEY, lambda t: 0.1)


@pytest.mark.cuda
def test_advi_takes_the_kernel_on_the_card():
    dev = _cuda()
    dens = _density("diagonal", 100, device=dev)
    before = advi_step.fused_meanfield_advi.launches
    res = variational.advi(dens, {}, KEY, n_iters=200, n_samples=32)
    assert advi_step.fused_meanfield_advi.launches == before + 1
    assert res.params["loc"]["z"].device.type == "cuda"
    assert torch.isfinite(res.losses).all()
    res = variational.advi(dens, {}, KEY, n_iters=20, n_samples=32,
                           experimental_fused=False)
    assert advi_step.fused_meanfield_advi.launches == before + 1
    assert res.losses.shape == (20,)


# Every cluster size advi_layout can return (1-16), each at the warps the
# rule gives there: rows fewer than the blocks (n = 3, 5, 7), n not a
# multiple of the split, both layouts (a lane a row at dim <= 4, a warp a row
# above) and every warp-a-row width (K = 1, 2, 4).
LAYOUT_CASES = [("toy2d", 2, 3), ("toy2d", 2, 5), ("diagonal", 3, 7),
                ("toy2d", 2, 500), ("equicorrelated", 4, 33),
                ("diagonal", 1, 1000), ("diagonal", 100, 7),
                ("diagonal", 100, 64), ("equicorrelated", 37, 75),
                ("diagonal", 200, 70), ("equicorrelated", 400, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, 17))
@pytest.mark.parametrize("kind,d,n", LAYOUT_CASES)
def test_every_layout_matches_plain_version_bit_for_bit(kind, d, n, cluster):
    """1, 2 and 10 steps, on the kernel's own draws and on injected noise:
    0 differing elements at every cluster size."""
    dev = _cuda()
    dens = _density(kind, d, device=dev)
    loc0 = torch.zeros(d, device=dev)
    ls0 = torch.full((d,), math.log(0.1), device=dev)
    if kind == "toy2d":
        loc0, ls0 = loc0 - 2.0, torch.full((d,), -5.0, device=dev)
    layout = (cluster, advi_step.advi_warps(d, n, cluster))
    g = torch.Generator(device=dev).manual_seed(n)
    for steps in (1, 2, 10):
        for noise in (None, torch.randn(steps, n, d, generator=g,
                                        device=dev)):
            before = advi_step.fused_meanfield_advi.launches
            got = advi_step.fused_meanfield_advi(
                dens, loc0, ls0, steps, n, KEY, lambda t: 0.05, noise=noise,
                _layout=layout)
            assert advi_step.fused_meanfield_advi.launches == before + 1
            want = advi_step.fused_meanfield_advi_reference(
                dens, loc0, ls0, steps, n, KEY, lambda t: 0.05, noise=noise)
            torch.cuda.synchronize()
            for name, a, b in zip(("loc", "log_scale", "losses"), got, want):
                assert int((a != b).sum()) == 0, (name, steps, layout)


@pytest.mark.cuda
def test_unschedulable_layout_raises():
    """A layout past the kernel's limits is refused by the wrapper; one
    the entry refuses raises with the CUDA error (no fallback)."""
    dev = _cuda()
    dens = _density("diagonal", 8, device=dev)
    z = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        advi_step.fused_meanfield_advi(dens, z, z, 2, 4, KEY, lambda t: 0.1,
                                       _layout=(17, 1))
    lib, _ = advi_step.kernel_library()
    rc = lib.zs_fused_meanfield_advi(
        0, *advi_step.density_pointers(dens, dev)[1:], z.data_ptr(),
        z.data_ptr(), z.data_ptr(), None, 1, 4, 8, 17, 1, 0.9, 0.1, 0.999,
        0.001, 1e-8, 0.0, 1, 2, z.data_ptr(), z.data_ptr(), z.data_ptr(),
        None)
    assert rc != 0
