"""Tests of zhusuan_tpu_torch's SGMCMC kernel modules (ops/sgld_step.py,
psgld_step.py, sghmc_step.py, sgnht_step.py) on the CPU.

Each kernel's plain version ``fused_*_step_reference`` runs the sampler's
own plain transition (``mcmc/sgmcmc.py::*_transition``) on the kernel's
Philox draws; here it is held to the sampler's plain path on the same
injected numbers, its draws to ``ops/_random.py``, and each sampler's gate
to its reasons. The JAX package's parity for the transitions is in
``tests/test_torch_sgmcmc.py``. The CUDA kernels themselves are held to
these plain versions on the card (the ``cuda`` tests below, and
``chip_smoke.py`` phase 12).
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch.mcmc import sgmcmc as tsg
from zhusuan_tpu_torch.mcmc.sgmcmc import SGMCMCState
from zhusuan_tpu_torch.ops import _random
from zhusuan_tpu_torch.ops.densities import (
    DiagonalGaussianLogJoint,
    EquicorrelatedGaussianLogJoint,
)
from zhusuan_tpu_torch.ops.hmc_step import MAX_DIM
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
    sgld_layout,
    sgld_step_supported,
)
from zhusuan_tpu_torch.ops.sgnht_step import (
    fused_sgnht_step,
    fused_sgnht_step_reference,
    sgnht_step_supported,
)

torch.set_num_threads(1)

C, D = 64, 37  # a ragged width: the kernels' last group of 4 is partial
LR = 0.01


def _density(kind, dtype, device="cpu"):
    if kind == "diagonal":
        return DiagonalGaussianLogJoint(
            "x", torch.linspace(-0.2, 0.2, D, dtype=dtype, device=device),
            torch.linspace(0.1, 1.0, D, dtype=dtype, device=device))
    return EquicorrelatedGaussianLogJoint("x", D, 0.95)


def _inputs(dtype, seed=0, device="cpu"):
    rs = np.random.RandomState(seed)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return dict(q=t(0.5 * rs.randn(C, D)), v=t(0.1 * rs.randn(C, D)),
                alpha=t(0.1 + 0.02 * rs.randn(C, D)),
                rms=t(rs.uniform(0.5, 4.0, (C, D))), eps=t(rs.randn(C, D)),
                eps_v=t(rs.randn(C, D)))


# (kind, sampler, call of the wrapper or its reference on the inputs)
def _cases():
    def sgld(fn, dens, x, noise, t, resample):
        return (fn(dens, x["q"], LR, (1, 2), t, noise=noise),)

    def psgld(fn, dens, x, noise, t, resample):
        return fn(dens, x["q"], x["rms"], LR, 0.9, 0.1, (1, 2), t,
                  noise=noise)

    def sghmc(order):
        def call(fn, dens, x, noise, t, resample):
            return fn(dens, x["q"], x["v"], LR, 0.3, 0.02, order, (1, 2), t,
                      resample=resample, noise=noise)
        return call

    def sgnht(order):
        def call(fn, dens, x, noise, t, resample):
            return fn(dens, x["q"], x["v"], x["alpha"], LR, 0.1, 1.0, order,
                      (1, 2), t, resample=resample, noise=noise)
        return call

    return {
        "sgld": (tsg.SGLD(LR), sgld, fused_sgld_step,
                 fused_sgld_step_reference),
        "psgld": (tsg.PSGLD(LR, decay=0.9, epsilon=0.1), psgld,
                  fused_psgld_step, fused_psgld_step_reference),
        "sghmc1": (tsg.SGHMC(LR, friction=0.3, variance_estimate=0.02,
                             n_iter_resample_v=4, second_order=False),
                   sghmc(False), fused_sghmc_step,
                   fused_sghmc_step_reference),
        "sghmc2": (tsg.SGHMC(LR, friction=0.3, variance_estimate=0.02,
                             n_iter_resample_v=4, second_order=True),
                   sghmc(True), fused_sghmc_step, fused_sghmc_step_reference),
        "sgnht1": (tsg.SGNHT(LR, variance_extra=0.1, n_iter_resample_v=4,
                             second_order=False), sgnht(False),
                   fused_sgnht_step, fused_sgnht_step_reference),
        "sgnht2": (tsg.SGNHT(LR, variance_extra=0.1, n_iter_resample_v=4,
                             second_order=True), sgnht(True),
                   fused_sgnht_step, fused_sgnht_step_reference),
    }


CASES = _cases()
MOMENTUM = ("sghmc1", "sghmc2", "sgnht1", "sgnht2")


def _sampler_step(kind, dens, x, t, resample):
    """The sampler's plain path on the same injected numbers, as the
    reference's outputs."""
    sampler = CASES[kind][0]
    st = SGMCMCState(q={"x": x["q"]}, t=t,
                     v={"x": x["v"]} if kind in MOMENTUM else {},
                     alpha={"x": x["alpha"]} if kind.startswith("sgnht")
                     else {},
                     rms={"x": x["rms"]} if kind == "psgld" else {})
    noise = ((x["eps"], x["eps_v"] if resample else None)
             if kind in MOMENTUM else x["eps"])
    new, info = sampler.sample(dens, {}, st, noise=noise)
    if kind == "psgld":
        return new.q["x"], new.rms["x"]
    if kind.startswith("sghmc"):
        v = new.v["x"]
        # The per-chain sums, as the kernel writes them.
        vsq = torch.sum(v * v, -1, dtype=torch.float64).to(v.dtype)
        return new.q["x"], v, vsq
    if kind.startswith("sgnht"):
        return new.q["x"], new.v["x"], new.alpha["x"]
    return (new.q["x"],)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("density", ["diagonal", "equicorrelated"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_reference_is_the_samplers_plain_transition(kind, density, dtype):
    x = _inputs(dtype, seed=len(kind))
    dens = _density(density, dtype)
    _, call, _, reference = CASES[kind]
    for t, resample in ((4, True), (5, False)):
        if resample and kind not in MOMENTUM:
            continue
        noise = ((x["eps"], x["eps_v"] if resample else None)
                 if kind in MOMENTUM else x["eps"])
        got = call(reference, dens, x, noise, t + 1, resample)
        want = _sampler_step(kind, dens, x, t, resample)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            if dtype == torch.float32:
                assert torch.equal(g, w)
            else:
                torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_cpu_wrapper_runs_reference_without_counting(kind):
    x = _inputs(torch.float32, seed=3)
    dens = _density("diagonal", torch.float32)
    _, call, wrapper, reference = CASES[kind]
    resample = kind in MOMENTUM
    before = wrapper.launches
    got = call(wrapper, dens, x, None, 7, resample)
    want = call(reference, dens, x, None, 7, resample)
    assert wrapper.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_reference_draws_the_kernel_philox_streams(kind):
    """Without noise the plain version draws ``STREAM_SGMCMC_NOISE`` (and,
    resampling, ``STREAM_SGMCMC_RESAMPLE``): the same as injecting those
    draws."""
    x = _inputs(torch.float32, seed=4)
    dens = _density("equicorrelated", torch.float32)
    _, call, _, reference = CASES[kind]
    key, t = (1, 2), 9
    eps = _random.philox_normal(key, t, (C, D), _random.STREAM_SGMCMC_NOISE)
    eps_v = _random.philox_normal(key, t, (C, D),
                                  _random.STREAM_SGMCMC_RESAMPLE)
    resample = kind in MOMENTUM
    own = call(reference, dens, x, None, t, resample)
    noise = (eps, eps_v) if resample else eps
    given = call(reference, dens, x, noise, t, resample)
    for g, w in zip(own, given):
        assert torch.equal(g, w)
    if resample:
        # The resampled momentum comes from its own stream.
        swapped = call(reference, dens, x, (eps_v, eps), t, resample)
        assert not torch.equal(swapped[1], own[1])


def test_sgmcmc_streams_are_distinct():
    key, t, shape = (5, 6), 3, (C, D)
    streams = (_random.STREAM_MOMENTUM, _random.STREAM_NUTS_DIRECTION,
               _random.STREAM_SGMCMC_NOISE, _random.STREAM_SGMCMC_RESAMPLE)
    assert len(set(streams)) == len(streams)
    draws = [_random.philox_normal(key, t, shape, s) for s in streams]
    for i in range(len(draws)):
        for j in range(i + 1, len(draws)):
            assert not torch.equal(draws[i], draws[j])
    big = _random.philox_normal((7, 8), 1, (4096, 100),
                                _random.STREAM_SGMCMC_NOISE).double()
    assert abs(float(big.mean())) < 0.005
    assert abs(float(big.std()) - 1.0) < 0.005


def test_sghmc_reference_resample_and_kinetic_sums():
    x = _inputs(torch.float64, seed=5)
    dens = _density("diagonal", torch.float64)
    eps = (x["eps"], x["eps_v"])
    q1, v1, vsq = fused_sghmc_step_reference(
        dens, x["q"], x["v"], LR, 0.3, 0.0, True, None, 1, resample=True,
        noise=eps)
    # A resample ignores the carried momentum.
    q2, v2, _ = fused_sghmc_step_reference(
        dens, x["q"], 7.0 * x["v"], LR, 0.3, 0.0, True, None, 1,
        resample=True, noise=eps)
    assert torch.equal(q1, q2) and torch.equal(v1, v2)
    torch.testing.assert_close(vsq, (v1 * v1).sum(-1), rtol=1e-14,
                               atol=0.0)
    # Without a resample the carried momentum enters.
    q3, _, _ = fused_sghmc_step_reference(
        dens, x["q"], x["v"], LR, 0.3, 0.0, True, None, 1, noise=eps)
    assert not torch.equal(q3, q1)


# --------------------------------------------------------------------- #
# The gates and the wrappers' refusals
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("supported", [
    sgld_step_supported, psgld_step_supported, sghmc_step_supported,
    sgnht_step_supported])
@pytest.mark.parametrize("shape,dtype,ok", [
    ((32768, 100), torch.float32, True),
    ((1000, 37), None, True),
    ((8, MAX_DIM), torch.float32, True),
    ((8, MAX_DIM + 1), torch.float32, False),
    ((8,), torch.float32, False),
    ((2, 8, 8), torch.float32, False),
    ((8, 8), torch.bfloat16, False),
    ((8, 8), torch.float64, False),
])
def test_step_supported(supported, shape, dtype, ok):
    assert supported(shape, dtype) is ok


@pytest.mark.parametrize("kind", sorted(CASES))
def test_gate_reasons(kind):
    sampler = CASES[kind][0]
    dens = _density("diagonal", torch.float32)
    equi = _density("equicorrelated", torch.float32)
    q = {"x": torch.zeros(8, D)}
    why = sampler._fused_ineligible
    assert why(dens, {}, q, LR) is None
    assert why(equi, {}, q, LR) is None
    assert why(dens, {}, q, torch.tensor(LR)) is None
    assert "single tensor" in why(dens, {}, dict(q, y=torch.zeros(8, D)),
                                  LR)
    reason = why(lambda o: -(o["x"] ** 2).sum(-1), {}, q, LR)
    assert "built-in" in reason and "Equicorrelated" in reason
    assert "float32" in why(dens, {}, {"x": q["x"].bfloat16()}, LR)
    assert "float32" in why(dens, {}, {"x": torch.zeros(8)}, LR)
    assert "over the latent" in why(dens, {}, {"y": q["x"]}, LR)
    assert "dim" in why(dens, {}, {"x": torch.zeros(8, D + 1)}, LR)
    assert "learning rate" in why(dens, {}, q, torch.ones(2))


def test_scalar_thermostat_takes_no_kernel():
    dens = _density("diagonal", torch.float32)
    q = {"x": torch.zeros(8, D)}
    scalar = tsg.SGNHT(LR, use_vector_alpha=False)
    assert "scalar thermostat" in scalar._fused_ineligible(dens, {}, q, LR)
    assert tsg.SGNHT(LR)._fused_ineligible(dens, {}, q, LR) is None
    # On the CPU even experimental_fused_step=True takes the plain path.
    s = tsg.SGNHT(LR, variance_extra=0.1, use_vector_alpha=False,
                  experimental_fused_step=True)
    st = s.init(q, key=(1, 2))
    before = fused_sgnht_step.launches
    st, info = s.sample(dens, {}, st, (3, 4))
    assert st.t == 1 and fused_sgnht_step.launches == before
    assert info.alpha["x"].shape == ()


@pytest.mark.parametrize("kind", sorted(CASES))
def test_wrappers_refuse(kind):
    x = _inputs(torch.float32)
    dens = _density("diagonal", torch.float32)
    _, call, wrapper, _ = CASES[kind]
    resample = kind in MOMENTUM
    with pytest.raises(TypeError):
        call(wrapper, lambda o: o["x"].sum(-1), x, None, 1, resample)
    with pytest.raises(ValueError):
        call(wrapper, _density("equicorrelated", torch.float32),
             dict(x, q=torch.zeros(C, D, 2)), None, 1, resample)
    bad = {k: (v[:, :-1] if k != "q" else v) for k, v in x.items()}
    if kind != "sgld":
        with pytest.raises(ValueError):
            call(wrapper, dens, bad, None, 1, resample)
    noise = ((torch.zeros(C, D + 1), None) if kind in MOMENTUM
             else torch.zeros(C, D + 1))
    with pytest.raises(ValueError):
        call(wrapper, dens, x, noise, 1, False)
    if kind in MOMENTUM:
        with pytest.raises(ValueError, match="resample"):
            call(wrapper, dens, x, (x["eps"], None), 1, True)
    with pytest.raises(ValueError):
        call(wrapper, dens, dict(x, q=x["q"].to("meta")), None, 1, resample)


# --------------------------------------------------------------------- #
# On the card only: the CUDA kernels against their plain versions.
# --------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")


@pytest.mark.cuda
@pytest.mark.parametrize("density", ["diagonal", "equicorrelated"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_kernel_matches_reference_on_card(kind, density):
    _need_cuda()
    dev = torch.device("cuda")
    x = _inputs(torch.float32, seed=8, device=dev)
    dens = _density(density, torch.float32, dev)
    _, call, wrapper, reference = CASES[kind]
    for resample in ((False, True) if kind in MOMENTUM else (False,)):
        noise = ((x["eps"], x["eps_v"] if resample else None)
                 if kind in MOMENTUM else x["eps"])
        before = wrapper.launches
        got = call(wrapper, dens, x, noise, 3, resample)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        want = call(reference, dens, x, noise, 3, resample)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [tsg.SGLD, tsg.PSGLD, tsg.SGHMC, tsg.SGNHT])
def test_fused_true_raises_on_ineligible_cuda_input(cls):
    _need_cuda()
    s = cls(LR, experimental_fused_step=True)
    st = s.init({"x": torch.zeros(16, 4, device="cuda")}, key=(1, 2))
    with pytest.raises(ValueError):
        s.sample(lambda obs: -0.5 * (obs["x"] ** 2).sum(-1), {}, st, (1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("lr_on", ["device", "host"])
@pytest.mark.parametrize("chains", [1, 7, 33, 32768])
@pytest.mark.parametrize("kind,d", [("diagonal", 100), ("diagonal", 8),
                                    ("diagonal", 37),
                                    ("equicorrelated", 100)])
def test_sgld_both_bodies_match_reference(kind, d, chains, lr_on):
    """K3 on the flat body (diagonal, d % 4 == 0) and the warp body: every
    element bit for bit on the diagonal density (within 1e-4 on the
    equicorrelated one, whose row sum runs in another order), on the
    kernel's own draws and on injected ones; where the flat body runs,
    the warp body gives the same bits."""
    _need_cuda()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(chains + d)
    if kind == "diagonal":
        dens = DiagonalGaussianLogJoint(
            "x", 0.1 * torch.randn(d, generator=g, device=dev),
            torch.linspace(0.1, 1.0, d, device=dev))
    else:
        dens = EquicorrelatedGaussianLogJoint("x", d, 0.95)
    q = torch.randn(chains, d, generator=g, device=dev)
    lr = torch.tensor(LR, device=dev) if lr_on == "device" else LR
    flat = sgld_layout(dens, d) == "flat"
    assert flat == (kind == "diagonal" and d % 4 == 0)
    for noise in (None, torch.randn(chains, d, generator=g, device=dev)):
        before = fused_sgld_step.launches
        got = fused_sgld_step(dens, q, lr, (5, 6), 11, noise=noise)
        assert fused_sgld_step.launches == before + 1
        want = fused_sgld_step_reference(dens, q, lr, (5, 6), 11,
                                         noise=noise)
        torch.cuda.synchronize()
        if kind == "diagonal":
            assert int((got != want).sum()) == 0
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        if flat:
            warp = fused_sgld_step(dens, q, lr, (5, 6), 11, noise=noise,
                                   _path="warp")
            assert torch.equal(got, warp)


@pytest.mark.cuda
def test_sgld_misaligned_view_takes_the_warp_body():
    """A state that starts off a 16-byte boundary cannot take the flat
    body's 16-byte loads: the wrapper sends it to the warp body, which
    gives the same bits."""
    _need_cuda()
    dev = torch.device("cuda")
    c, d = 33, 8
    dens = DiagonalGaussianLogJoint("x", torch.zeros(d, device=dev),
                                    torch.linspace(0.1, 1.0, d, device=dev))
    buf = torch.randn(c * d + 1, device=dev)
    q = buf[1:].view(c, d)
    assert q.data_ptr() % 16 != 0
    got = fused_sgld_step(dens, q, LR, (5, 6), 2)
    want = fused_sgld_step_reference(dens, q, LR, (5, 6), 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, fused_sgld_step(dens, q.clone(), LR, (5, 6), 2))
