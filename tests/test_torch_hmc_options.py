"""Parity tests of the HMC options the port added in its inference-checking
slice: ``step_size_jitter``, ``check_numerics``, ``sample``'s
``reinit_step_size`` / ``init_step_size_search`` and ``warmup_run``,
against the JAX package on the CPU in float64.

The JAX draws of an iteration come from ``split(key, 3) -> key_p, key_u,
key_j`` (``zhusuan_tpu/mcmc/hmc.py:557``): the momentum's normals from
``split(key_p, 1)[0]``, the MH uniforms from ``key_u``, the jitter factor
from ``key_j``; they reach the port through ``noise=(eps, u, u_jitter)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu.mcmc.hmc as jhmc_mod
from zhusuan_tpu.mcmc.hmc import HMC as JHMC
from zhusuan_tpu_torch.mcmc.hmc import (
    HMC as THMC,
    state_from_numpy,
    state_to_numpy,
    warmup_schedule,
)
from zhusuan_tpu_torch.ops.hmc_step import (
    DiagonalGaussianLogJoint,
    fused_hmc_step,
    fused_hmc_step_reference,
)

torch.set_num_threads(1)

C, D = 32, 6
STD = np.linspace(0.3, 1.5, D)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def jlj(obs):
    return jnp.sum(-0.5 * (obs["x"] / STD) ** 2, -1)


def tlj(obs):
    return torch.sum(-0.5 * (obs["x"] / _t(STD)) ** 2, -1)


def _jax_noise(key, shape, dtype, mass, jitter):
    """The draws ``HMC.sample(key)`` makes on the JAX scan path."""
    key_p, key_u, key_j = jax.random.split(key, 3)
    (kp,) = jax.random.split(key_p, 1)
    eps = np.asarray(jax.random.normal(kp, shape, dtype))
    u = np.asarray(jax.random.uniform(key_u, shape[:1], dtype))
    out = [_t(eps), _t(u)]
    if jitter:
        out.append(_t(jax.random.uniform(key_j, (), dtype,
                                         minval=1.0 - jitter,
                                         maxval=1.0 + jitter)))
    return tuple(out)


def _pair(**kw):
    return JHMC(**kw), THMC(**kw)


def _start(jhmc, seed=3):
    q0 = np.random.RandomState(seed).randn(C, D) * STD
    jst = jhmc.init({"x": jnp.asarray(q0)}, log_joint=jlj)
    return jst, state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))


def _same_state(tst, jst, tol):
    final = state_to_numpy(tst)
    assert int(final.t) == int(jst.t)
    for name in ("q", "step_size", "mass", "h_bar", "log_epsilon_bar",
                 "da_step"):
        want = getattr(jst, name)
        want = ({k: np.asarray(v) for k, v in want.items()}
                if isinstance(want, dict) else np.asarray(want))
        _close(getattr(final, name), want, tol)


# --------------------------------------------------------------------- #
# step_size_jitter
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("adapt", [None, True])
def test_one_jittered_transition_matches_jax(adapt):
    kw = dict(step_size=0.4, n_leapfrogs=4, adapt_step_size=adapt,
              step_size_jitter=0.3)
    jhmc, thmc = _pair(**kw)
    jst, tst = _start(jhmc)
    key = jax.random.PRNGKey(7)
    jst2, info = jhmc.sample(jlj, {}, jst, key)
    noise = _jax_noise(key, (C, D), jnp.float64, None, 0.3)
    tst2, tinfo = thmc.sample(tlj, {}, tst, noise=noise)
    for f in ("acceptance_rate", "updated_step_size", "orig_hamiltonian",
              "hamiltonian", "orig_log_prob", "log_prob", "samples",
              "init_momentum"):
        _close(getattr(tinfo, f), jax.tree_util.tree_map(
            np.asarray, getattr(info, f)), 1e-10)
    _same_state(tst2, jst2, 1e-10)


def test_jitter_changes_the_trajectory_and_the_noise_must_carry_it():
    jhmc, thmc = _pair(step_size=0.4, n_leapfrogs=4, step_size_jitter=0.3)
    _, tst = _start(jhmc)
    eps, u, u_j = _jax_noise(jax.random.PRNGKey(1), (C, D), jnp.float64,
                             None, 0.3)
    a = thmc.sample(tlj, {}, tst, noise=(eps, u, u_j))[1]
    b = thmc.sample(tlj, {}, tst, noise=(eps, u, torch.ones_like(u_j)))[1]
    plain = THMC(step_size=0.4, n_leapfrogs=4).sample(
        tlj, {}, tst, noise=(eps, u))[1]
    _close(b.hamiltonian, plain.hamiltonian, 1e-12)
    assert not torch.allclose(a.hamiltonian, b.hamiltonian)
    with pytest.raises(ValueError, match="u_jitter"):
        thmc.sample(tlj, {}, tst, noise=(eps, u))
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        THMC(step_size_jitter=1.0)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        JHMC(step_size_jitter=1.0)


def test_jittered_runs_reproduce_per_key():
    thmc = THMC(step_size=0.5, n_leapfrogs=3, step_size_jitter=0.25)
    st = thmc.init({"x": torch.zeros(4, 2, dtype=torch.float64)},
                   n_chain_dims=1)
    lj = lambda o: -0.5 * (o["x"] ** 2).sum(-1)  # noqa: E731
    # One key gives one run; the jitter is the only difference from the
    # unjittered sampler on the same key (momentum drawn first).
    a = thmc.run(lj, {}, st, (5, 6), 20, collect_fields=("log_prob",))[1]
    b = thmc.run(lj, {}, st, (5, 6), 20, collect_fields=("log_prob",))[1]
    assert torch.equal(a["log_prob"], b["log_prob"])
    c = THMC(step_size=0.5, n_leapfrogs=3).run(
        lj, {}, st, (5, 6), 20, collect_fields=("log_prob",))[1]
    assert not torch.equal(a["log_prob"], c["log_prob"])


def test_thirty_chained_jittered_adaptive_iterations_match_jax():
    kw = dict(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
              adapt_mass=True, mass_collect_iters=10, step_size_jitter=0.1)
    jhmc, thmc = _pair(**kw)
    jst, tst = _start(jhmc, seed=6)
    step = jax.jit(lambda s, k: jhmc.sample(jlj, {}, s, k))
    for i in range(30):
        key = jax.random.PRNGKey(100 + i)
        jst_new, info = step(jst, key)
        eps, u, u_j = _jax_noise(key, (C, D), jnp.float64, None, 0.1)
        tst, tinfo = thmc.sample(tlj, {}, tst, noise=(eps, u, u_j))
        _close(tinfo.acceptance_rate, np.asarray(info.acceptance_rate),
               1e-8)
        jst = jst_new
    _same_state(tst, jst, 1e-8)
    assert not np.allclose(state_to_numpy(tst).mass["x"], 1.0)


# --------------------------------------------------------------------- #
# reinit_step_size / init_step_size_search
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("flag", [True, "tensor"])
def test_reinit_step_size_forces_a_search_and_a_fresh_start(flag):
    jhmc, thmc = _pair(step_size=0.05, n_leapfrogs=4, adapt_step_size=True)
    jst, tst = _start(jhmc)
    jst = jst._replace(t=jnp.asarray(5, jnp.int32))
    tst = tst._replace(t=5)
    key = jax.random.PRNGKey(11)
    jst2, info = jhmc.sample(jlj, {}, jst, key, reinit_step_size=True)
    noise = _jax_noise(key, (C, D), jnp.float64, None, 0.0)
    reinit = True if flag is True else torch.tensor(True)
    tst2, tinfo = thmc.sample(tlj, {}, tst, noise=noise,
                              reinit_step_size=reinit)
    _same_state(tst2, jst2, 1e-10)
    # Without it t == 6 runs no search: the step stays 0.05 going in.
    tst3, _ = thmc.sample(tlj, {}, tst, noise=noise)
    jst3, _ = jhmc.sample(jlj, {}, jst, key, reinit_step_size=False)
    _same_state(tst3, jst3, 1e-10)
    assert not np.allclose(float(tst2.step_size), float(tst3.step_size))


def test_init_step_size_search_false_suppresses_the_first_search():
    jhmc, thmc = _pair(step_size=0.05, n_leapfrogs=4, adapt_step_size=True)
    jst, tst = _start(jhmc)
    key = jax.random.PRNGKey(12)
    noise = _jax_noise(key, (C, D), jnp.float64, None, 0.0)
    for search in (None, False):
        jst2, _ = jhmc.sample(jlj, {}, jst, key,
                              init_step_size_search=search)
        tst2, _ = thmc.sample(tlj, {}, tst, noise=noise,
                              init_step_size_search=search)
        _same_state(tst2, jst2, 1e-10)
    # The forced search wins over the suppression, in both packages.
    jst2, _ = jhmc.sample(jlj, {}, jst, key, init_step_size_search=False,
                          reinit_step_size=True)
    tst2, _ = thmc.sample(tlj, {}, tst, noise=noise,
                          init_step_size_search=False, reinit_step_size=True)
    _same_state(tst2, jst2, 1e-10)


@pytest.mark.parametrize("bad", [True, 0, "no"])
def test_init_step_size_search_rejects_anything_but_none_or_false(bad):
    jhmc, thmc = _pair(step_size=0.05, adapt_step_size=True)
    jst, tst = _start(jhmc)
    with pytest.raises(ValueError) as jerr:
        jhmc.sample(jlj, {}, jst, jax.random.PRNGKey(0),
                    init_step_size_search=bad)
    with pytest.raises(ValueError) as terr:
        thmc.sample(tlj, {}, tst, (1, 2), init_step_size_search=bad)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="static Python False"):
        thmc.sample(tlj, {}, tst, (1, 2),
                    init_step_size_search=torch.tensor(False))


# --------------------------------------------------------------------- #
# check_numerics
# --------------------------------------------------------------------- #
def test_check_numerics_raises_in_both_packages_on_a_nonfinite_start():
    kw = dict(step_size=0.1, n_leapfrogs=2, check_numerics=True)
    jhmc, thmc = _pair(**kw)
    q0 = np.zeros((C, D))
    q0[3, 1] = np.nan
    jst = jhmc.init({"x": jnp.asarray(q0)}, log_joint=jlj)
    with pytest.raises(Exception, match="old_log_prob has numeric errors"):
        out = jax.jit(lambda s, k: jhmc.sample(jlj, {}, s, k))(
            jst, jax.random.PRNGKey(0))
        jax.block_until_ready(out)
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    with pytest.raises(FloatingPointError,
                       match="old_log_prob has numeric errors"):
        thmc.sample(tlj, {}, tst, (1, 2))
    # A finite start passes and agrees with the unchecked sampler.
    ok = tst._replace(q={"x": torch.zeros(C, D, dtype=torch.float64)})
    a = thmc.sample(tlj, {}, ok, (1, 2))[1]
    b = THMC(step_size=0.1, n_leapfrogs=2).sample(tlj, {}, ok, (1, 2))[1]
    assert torch.equal(a.log_prob, b.log_prob)


class _OnTheCard:
    """A stand-in for a CUDA tensor in the kernel gate's device test."""

    is_cuda = True


def test_check_numerics_takes_the_plain_path_and_explicit_fused_raises():
    dens = DiagonalGaussianLogJoint("x", torch.zeros(D), torch.ones(D))
    q = {"x": torch.zeros(8, D)}
    m = {"x": torch.ones(1, D)}
    card = {"x": _OnTheCard()}
    # The input itself is eligible: only the option sends it to the plain
    # path ("auto") or raises (True), as the JAX gate excludes it.
    assert THMC._fused_ineligible(dens, {}, q, m, 1) is None
    assert not THMC(check_numerics=True)._use_fused_step(dens, {}, card, m,
                                                         1)
    with pytest.raises(ValueError, match="check_numerics"):
        THMC(check_numerics=True, experimental_fused_step=True)\
            ._use_fused_step(dens, {}, card, m, 1)
    assert not THMC(check_numerics=True, experimental_fused_step=True)\
        ._use_fused_step(dens, {}, q, m, 1)  # CPU tensors: plain


# --------------------------------------------------------------------- #
# warmup_run
# --------------------------------------------------------------------- #
class _Recorder:
    """``jnp`` for ``zhusuan_tpu/mcmc/hmc.py`` that records the bool
    arrays ``warmup_run`` builds its schedule from."""

    def __init__(self):
        self.arrays = []

    def asarray(self, x, *a, **k):
        if isinstance(x, np.ndarray) and x.dtype == bool:
            self.arrays.append(x.copy())
        return jnp.asarray(x, *a, **k)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("n,init,term,base", [
    (200, 75, 50, 25), (1000, 75, 50, 25), (150, 75, 50, 25),
    (301, 30, 20, 10), (125, 50, 50, 25)])
def test_warmup_schedule_equals_jax(monkeypatch, n, init, term, base):
    rec = _Recorder()
    monkeypatch.setattr(jhmc_mod, "jnp", rec)
    jhmc = JHMC(step_size=0.1, n_leapfrogs=1, adapt_step_size=True)
    jst = jhmc.init({"x": jnp.zeros((2, 2))}, n_chain_dims=1)
    lj = lambda o: -0.5 * jnp.sum(o["x"] ** 2, -1)  # noqa: E731
    jax.eval_shape(lambda s: jhmc.warmup_run(
        lj, {}, s, jax.random.PRNGKey(0), n, init, term, base), jst)
    accumulate, install, reinit = warmup_schedule(n, init, term, base)
    assert len(rec.arrays) == 3
    for got, want in zip((accumulate, install, reinit), rec.arrays):
        np.testing.assert_array_equal(got, want)
    assert install.sum() >= 1 and reinit[0] == 0


@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_warmup_run_200_iterations_matches_jax(jitter):
    n_warmup = 200
    kw = dict(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
              step_size_jitter=jitter)
    jhmc, thmc = _pair(**kw)
    jst, tst = _start(jhmc, seed=9)
    key = jax.random.PRNGKey(21)
    jfinal = jax.jit(lambda s, k: jhmc.warmup_run(jlj, {}, s, k, n_warmup))(
        jst, key)
    noise, k = [], key
    for _ in range(n_warmup):
        k, sub = jax.random.split(k)
        noise.append(_jax_noise(sub, (C, D), jnp.float64, None, jitter))
    tfinal = thmc.warmup_run(tlj, {}, tst, None, n_warmup, noise=noise)
    assert tfinal.t == n_warmup
    _same_state(tfinal, jfinal, 1e-8)
    m = state_to_numpy(tfinal).mass["x"]
    assert m.shape == (1, D) and not np.allclose(m, 1.0)


def test_warmup_run_on_a_builtin_density_keeps_a_1_by_dim_mass():
    dens = DiagonalGaussianLogJoint("x", torch.zeros(D), torch.as_tensor(
        STD, dtype=torch.float32))
    thmc = THMC(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
                step_size_jitter=0.1)
    st = thmc.init({"x": torch.zeros(64, D)}, log_joint=dens)
    out = thmc.warmup_run(dens, {}, st, torch.Generator().manual_seed(0),
                          160, init_buffer=40, term_buffer=30,
                          base_window=20)
    assert out.mass["x"].shape == (1, D)
    assert out.mass["x"].dtype == torch.float32
    # The installed precision tracks 1 / var of the target.
    ratio = out.mass["x"][0].double().numpy() * STD ** 2
    assert np.all((ratio > 0.4) & (ratio < 2.5)), ratio


def test_warmup_run_short_budget_falls_back_to_run():
    thmc = THMC(step_size=0.1, n_leapfrogs=3, adapt_step_size=True)
    st = thmc.init({"x": torch.zeros(C, D, dtype=torch.float64)},
                   n_chain_dims=1)
    got = thmc.warmup_run(tlj, {}, st, (3, 4), 100)
    want = thmc.run(tlj, {}, st, (3, 4), 100, n_adapt=100,
                    collect=False)[0]
    assert got.t == want.t == 100
    assert torch.equal(got.q["x"], want.q["x"])
    assert torch.equal(got.step_size, want.step_size)


def test_warmup_run_errors_match_jax():
    cases = [
        (dict(step_size=0.1), {"x": np.zeros((4, 2))}, "adapt_step_size"),
        (dict(step_size=0.1, adapt_step_size=True, adapt_mass=True),
         {"x": np.zeros((4, 2))}, "owns the mass"),
        (dict(step_size=0.1, adapt_step_size=True),
         {"x": np.zeros((3, 4, 2))}, "exactly one chain axis"),
    ]
    for kw, q, msg in cases:
        jhmc, thmc = _pair(**kw)
        nd = q["x"].ndim - 1
        jst = jhmc.init({"x": jnp.asarray(q["x"])}, n_chain_dims=nd)
        tst = thmc.init({"x": _t(q["x"])}, n_chain_dims=nd)
        jlj2 = lambda o: -0.5 * jnp.sum(o["x"] ** 2, -1)  # noqa: E731
        tlj2 = lambda o: -0.5 * torch.sum(o["x"] ** 2, -1)  # noqa: E731
        with pytest.raises(ValueError, match=msg) as jerr:
            jhmc.warmup_run(jlj2, {}, jst, jax.random.PRNGKey(0), 200)
        with pytest.raises(ValueError, match=msg) as terr:
            thmc.warmup_run(tlj2, {}, tst, (1, 2), 200)
        assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------------- #
# on the card: K1 on a jittered step with an installed mass
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_kernel_on_a_jittered_step_with_an_installed_mass():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the HMC kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    c, d = 4096, 100
    dens = DiagonalGaussianLogJoint(
        "x", torch.zeros(d, device=dev), torch.linspace(0.1, 1.0, d,
                                                        device=dev))
    q = dens.scale * torch.randn(c, d, generator=g, device=dev)
    mass = 1.0 / dens.scale[None] ** 2 * (
        0.8 + 0.4 * torch.rand(1, d, generator=g, device=dev))
    noise = (torch.randn(c, d, generator=g, device=dev),
             torch.rand(c, generator=g, device=dev))
    step = torch.full((), 0.3, device=dev) * torch.empty(
        (), device=dev).uniform_(0.9, 1.1, generator=g)
    got = fused_hmc_step(dens, q, mass, step, 5, (1, 2), 3, noise=noise)
    want = fused_hmc_step_reference(dens, q, mass, step, 5, (1, 2), 3,
                                    noise=noise)
    u = noise[1]
    assert int(((u < got[2]) != (u < want[2])).sum()) == 0
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= 1e-4 * (
            1.0 + float(b.float().abs().max()))
