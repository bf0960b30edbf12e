"""Parity tests of zhusuan_tpu_torch's NUTS slice (mcmc/nuts.py,
ops/nuts_step.py, the NUTS Philox streams) against the JAX package, on the
CPU in float64.

The JAX scan path draws its random numbers inside per-chain while-loops;
:func:`_jax_draws` rebuilds them from the key with the same ``jax.random``
calls (``mcmc/nuts.py:439-440, 452-453, 359-361, 473, 717``), including the
draws past the point where a tree stopped (never used, so precomputing every
leaf is exact), and the port takes them through its ``noise=`` hooks. The
Pallas kernels draw from the TPU's hardware PRNG and have no CPU lowering,
so the JAX side is the scan path the kernels are held to. The CUDA kernel
itself is checked against its plain version on the card (``cuda``-marked
tests here, and ``chip_smoke.py``).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc.hmc import HMCState as JHMCState
from zhusuan_tpu.mcmc.nuts import NUTS as JNUTS
from zhusuan_tpu_torch.mcmc.hmc import state_from_numpy, state_to_numpy
from zhusuan_tpu_torch.mcmc.nuts import (
    NUTS as TNUTS,
    _Flattener,
    _trailing_ones,
    nuts_transition,
    value_and_grad,
)
from zhusuan_tpu_torch.ops import _random
from zhusuan_tpu_torch.ops.hmc_step import DiagonalGaussianLogJoint
from zhusuan_tpu_torch.ops.nuts_step import (
    MAX_DIM,
    MAX_TREE_DEPTH,
    fused_nuts_transition,
    fused_nuts_transition_reference,
    nuts_noise,
    nuts_step_supported,
)

torch.set_num_threads(1)

TOL = 1e-10
FIELDS = ("samples", "log_prob", "energy", "acceptance_rate", "depth",
          "n_leapfrogs", "turning", "divergent")


def _t(x):
    return torch.as_tensor(np.array(x))


def _draws_one(key, dim, depth):
    """One chain's draws, as ``NUTS._transition_one`` makes them:
    ``(eps [dim], u_dir [D], u_leaf [2**D - 1], u_merge [D])``.
    ``bernoulli(key)`` is ``uniform(key, (), float64) < 0.5`` (its default
    ``p`` is a Python float)."""
    key, key_mom = jax.random.split(key)
    eps = jax.random.normal(key_mom, (dim,), jnp.float64)
    u_dir, u_merge, u_leaf = [], [], []
    for k in range(depth):
        key, key_dir, key_sub, key_take = jax.random.split(key, 4)
        u_dir.append(jax.random.uniform(key_dir, (), jnp.float64))
        u_merge.append(jax.random.uniform(key_take, dtype=jnp.float64))

        def leaf(kk, _):
            kk, sub = jax.random.split(kk)
            return kk, jax.random.uniform(sub, dtype=jnp.float64)

        _, us = jax.lax.scan(leaf, key_sub, None, length=1 << k)
        u_leaf.append(us)
    return eps, jnp.stack(u_dir), jnp.concatenate(u_leaf), jnp.stack(u_merge)


_DRAWS = {}


def _jax_draws(key, n_chains, dim, depth):
    """The draws of ``NUTS.sample`` for ``n_chains`` flattened chains
    (``None`` for a latent without chain axes), as float64 tensors."""
    sig = (n_chains, dim, depth)
    if sig not in _DRAWS:
        one = lambda k: _draws_one(k, dim, depth)  # noqa: E731
        _DRAWS[sig] = jax.jit(
            (lambda k: jax.tree.map(lambda v: v[None], one(k)))
            if n_chains is None
            else (lambda k: jax.vmap(one)(jax.random.split(k, n_chains))))
    return tuple(_t(v) for v in _DRAWS[sig](key))


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype.kind in "bi":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   want.astype(np.float64),
                                   rtol=tol, atol=tol)


def _info_fields(info):
    return {"samples": info.samples, "log_prob": info.log_prob,
            "energy": info.energy, "acceptance_rate": info.acceptance_rate,
            "depth": info.depth, "n_leapfrogs": info.n_leapfrogs,
            "turning": info.turning, "divergent": info.divergent}


# --------------------------------------------------------------------- #
# The plain transition against the JAX scan path on JAX's own draws
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("depth,step,seed", [
    (4, 0.3, 0), (8, 0.1, 1), (8, 2.6, 2)], ids=["depth4", "depth8",
                                                  "divergent"])
def test_plain_transition_matches_jax_scan_path(depth, step, seed):
    c, d = 64, 8
    rs = np.random.RandomState(seed)
    std = np.linspace(0.5, 2.0, d)
    q0 = rs.randn(c, d) * std
    mass = rs.uniform(0.5, 2.0, (1, d))

    def jlj(obs):
        return jnp.sum(-0.5 * (obs["x"] / std) ** 2, -1)

    nuts = JNUTS(step_size=step, max_tree_depth=depth)
    st = nuts.init({"x": jnp.asarray(q0)}, n_chain_dims=1)
    st = st._replace(mass={"x": jnp.asarray(mass)})
    key = jax.random.PRNGKey(10 + seed)
    _, info = jax.jit(lambda s, k: nuts.sample(jlj, {}, s, k))(st, key)
    noise = _jax_draws(key, c, d, depth)

    # The direction layout: bernoulli(key_dir) is u_dir < 0.5.
    k = jax.random.split(jax.random.split(key, c)[0])[0]
    _, key_dir, _, _ = jax.random.split(k, 4)
    assert bool(jax.random.bernoulli(key_dir)) == bool(noise[1][0, 0] < 0.5)

    dens = DiagonalGaussianLogJoint("x", torch.zeros(d, dtype=torch.float64),
                                    _t(std))
    got = nuts_transition(value_and_grad(dens.log_prob), _t(q0),
                          1.0 / _t(mass)[0], step, depth, 1000.0, noise)
    want = _info_fields(info)
    for name, g in zip(FIELDS, got):
        _close(g, want[name] if name != "samples" else want[name]["x"])
    assert got[4].dtype == got[5].dtype == torch.int32
    assert got[6].dtype == got[7].dtype == torch.bool

    depth_reached = np.asarray(info.depth)
    turned = np.asarray(info.turning)
    diverged = np.asarray(info.divergent)
    if step > 1.0:  # a mix of divergent and regular chains
        assert 0 < diverged.mean() < 1
    else:  # a mix of U-turns and trees stopped at the cap
        assert not diverged.any()
        assert turned.any()
        assert (depth_reached >= min(depth, 5)).any()
        if depth == 4:
            assert ((depth_reached == depth) & ~turned).any()


# --------------------------------------------------------------------- #
# Chained adaptive sample iterations and the state round trip
# --------------------------------------------------------------------- #
def test_chained_adaptive_sample_matches_jax():
    n_iter, c, d, depth = 30, 32, 8, 6
    target_std = np.linspace(0.1, 1.0, d)

    def jlj(obs):
        return jnp.sum(-0.5 * (obs["x"] / target_std) ** 2, -1)

    kw = dict(step_size=0.1, max_tree_depth=depth, adapt_step_size=True,
              adapt_mass=True, mass_collect_iters=10)
    jnuts, tnuts = JNUTS(**kw), TNUTS(**kw)
    tlj = DiagonalGaussianLogJoint("x", torch.zeros(d, dtype=torch.float64),
                                   _t(target_std))
    q0 = np.random.RandomState(6).randn(c, d)
    jst = jnuts.init({"x": jnp.asarray(q0)}, log_joint=jlj)
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    assert tst.t == 0 and tst.q["x"].dtype == torch.float64
    step = jax.jit(lambda s, k: jnuts.sample(jlj, {}, s, k))
    depths = []
    for i in range(n_iter):
        key = jax.random.PRNGKey(200 + i)
        jst, info = step(jst, key)
        tst, tinfo = tnuts.sample(tlj, {}, tst,
                                  noise=_jax_draws(key, c, d, depth))
        _close(tinfo.acceptance_rate, info.acceptance_rate, 1e-8)
        assert torch.equal(tinfo.depth, _t(info.depth))
        depths.append(np.asarray(info.depth).mean())
    assert tst.t == n_iter
    final = state_to_numpy(tst)
    for name in ("q", "step_size", "mass", "h_bar", "log_epsilon_bar",
                 "da_step", "ewmv_t", "ewmv_mean", "ewmv_var"):
        want = getattr(jst, name)
        want = ({k: np.asarray(v) for k, v in want.items()}
                if isinstance(want, dict) else np.asarray(want))
        _close(getattr(final, name), want, 1e-8)
    assert final.step_size.dtype == np.float64
    # The adapted mass is in use by the end, and trees of several depths
    # were built.
    assert not np.allclose(final.mass["x"], 1.0)
    assert max(depths) > min(depths)
    # The numpy state goes back into the JAX sampler unchanged.
    back = JHMCState(*[jax.tree_util.tree_map(jnp.asarray, v)
                       for v in final])
    _close(back.q["x"], jst.q["x"], 1e-8)


# --------------------------------------------------------------------- #
# Latent layouts: several latents, no chain axis, two chain axes,
# per-chain observed leaves
# --------------------------------------------------------------------- #
def _sample_both(jlj, tlj, q, n_chain_dims, depth, step, observed=None,
                 seed=0):
    jnuts = JNUTS(step_size=step, max_tree_depth=depth)
    tnuts = TNUTS(step_size=step, max_tree_depth=depth)
    jobs = {k: jnp.asarray(v) for k, v in (observed or {}).items()}
    tobs = {k: _t(v) for k, v in (observed or {}).items()}
    jst = jnuts.init({k: jnp.asarray(v) for k, v in q.items()},
                     n_chain_dims=n_chain_dims)
    tst = tnuts.init({k: _t(v) for k, v in q.items()},
                     n_chain_dims=n_chain_dims)
    key = jax.random.PRNGKey(50 + seed)
    _, info = jax.jit(lambda s, k: jnuts.sample(jlj, jobs, s, k))(jst, key)
    first = next(iter(q.values()))
    lead = first.shape[:n_chain_dims]
    n_chains = int(np.prod(lead)) if n_chain_dims else None
    dim = sum(int(np.prod(v.shape[n_chain_dims:])) for v in q.values())
    noise = _jax_draws(key, n_chains, dim, depth)
    _, tinfo = tnuts.sample(tlj, tobs, tst, noise=noise)
    want, got = _info_fields(info), _info_fields(tinfo)
    for name in FIELDS:
        _close(got[name], want[name])
    for name in ("log_prob", "depth", "turning"):
        assert tuple(got[name].shape) == tuple(lead)
    return info


def test_multi_latent_dict_matches_jax():
    """Two latents of different shapes exercise the flattener's
    sorted-name ravel."""
    rs = np.random.RandomState(3)
    q = {"v": rs.randn(16, 3), "mu": rs.randn(16)}

    def jlj(obs):
        return -0.5 * (obs["mu"] / 2.0) ** 2 + jnp.sum(-0.5 * obs["v"] ** 2,
                                                       -1)

    def tlj(obs):
        return -0.5 * (obs["mu"] / 2.0) ** 2 + torch.sum(
            -0.5 * obs["v"] ** 2, -1)

    info = _sample_both(jlj, tlj, q, 1, 6, 0.4)
    assert info.samples["v"].shape == (16, 3)


@pytest.mark.parametrize("n_chain_dims", [0, 2])
def test_chain_axes_match_jax(n_chain_dims):
    rs = np.random.RandomState(4)
    std = np.array([0.5, 1.5])
    shape = (2,) if n_chain_dims == 0 else (4, 8, 2)
    q = {"w": rs.randn(*shape)}

    def jlj(obs):
        return jnp.sum(-0.5 * (obs["w"] / std) ** 2, -1)

    def tlj(obs):
        return torch.sum(-0.5 * (obs["w"] / _t(std)) ** 2, -1)

    _sample_both(jlj, tlj, q, n_chain_dims, 5, 0.3, seed=n_chain_dims)


def test_per_chain_observed_leaves_match_jax():
    """An observed leaf that carries the chain shape conditions each chain
    on its own data (the JAX package vmaps it; the port evaluates all
    chains at once)."""
    rs = np.random.RandomState(5)
    c = 16
    q = {"w": rs.randn(c, 3)}
    observed = {"y": rs.randn(c), "s": np.array(0.7)}

    # On a chainless latent the density comes out chain-shaped (from y):
    # that is how the JAX package tells per-chain leaves apart.
    def jlj(obs):
        return (jnp.sum(-0.5 * (obs["w"] / obs["s"]) ** 2, -1)
                + obs["y"] * jnp.sum(obs["w"], -1))

    def tlj(obs):
        return (torch.sum(-0.5 * (obs["w"] / obs["s"]) ** 2, -1)
                + obs["y"] * torch.sum(obs["w"], -1))

    _sample_both(jlj, tlj, q, 1, 6, 0.3, observed=observed)


def test_density_not_scalar_per_chain_is_refused():
    nuts = TNUTS(step_size=0.1, max_tree_depth=3)
    st = nuts.init({"w": torch.zeros(4, 2, dtype=torch.float64)},
                   n_chain_dims=1)
    ones = torch.ones(4, dtype=torch.float64)  # a chain axis from nowhere
    with pytest.raises(ValueError, match="chainless latent"):
        nuts.sample(lambda obs: -0.5 * (obs["w"] ** 2).sum(-1) * ones, {},
                    st, (1, 2))


def test_flattener_and_trailing_ones():
    q = {"b": torch.zeros(5, 2, 3), "a": torch.zeros(5, dtype=torch.float64)}
    flat = _Flattener(q, 1)
    assert flat.names == ["a", "b"] and flat.dim == 7
    assert flat.dtype == torch.float64
    x = torch.arange(35, dtype=torch.float64).reshape(5, 7)
    tree = flat.unravel(x, (5,))
    assert tree["a"].shape == (5,) and tree["b"].shape == (5, 2, 3)
    assert tree["b"].dtype == torch.float32
    assert torch.equal(flat.ravel(tree, (5,)), x)
    assert [_trailing_ones(i) for i in range(8)] == [0, 1, 0, 2, 0, 1, 0, 3]


# --------------------------------------------------------------------- #
# Sampler behaviour, the run contract and the constructor
# --------------------------------------------------------------------- #
def _diag(stds, dtype=torch.float64):
    stds = torch.as_tensor(stds, dtype=dtype)
    return DiagonalGaussianLogJoint("w", torch.zeros_like(stds), stds)


def test_std_recovery_on_diag_gaussian():
    """The port's own run recovers a diagonal Gaussian (the JAX package's
    ``test_nuts.py:30`` at a smaller size). Measured on this configuration
    over five keys: worst relative std error 0.007-0.023 (0.010 at this
    key), worst |mean| / std 0.012-0.032 (0.025), acceptance 0.796-0.804;
    the bounds leave about 3x margin."""
    stds = [0.5, 1.0, 2.0, 4.0]
    nuts = TNUTS(step_size=0.2, max_tree_depth=8, adapt_step_size=True)
    st = nuts.init({"w": torch.zeros(128, 4, dtype=torch.float64)},
                   n_chain_dims=1)
    _, out = nuts.run(_diag(stds), {}, st, (3, 4), 300, n_adapt=150)
    post = out["samples"]["w"][150:].reshape(-1, 4).numpy()
    np.testing.assert_allclose(post.std(0), stds, rtol=0.07)
    assert np.max(np.abs(post.mean(0)) / stds) < 0.1
    acc = float(out["acceptance_rate"][150:].mean())
    assert 0.7 < acc < 0.9, acc


def test_divergences_flagged_and_depth_capped():
    nuts = TNUTS(step_size=50.0)  # no adaptation
    st = nuts.init({"w": torch.zeros(32, 2, dtype=torch.float64)},
                   n_chain_dims=1)
    _, out = nuts.run(_diag([0.1, 0.1]), {}, st, (5, 6), 20)
    assert out["divergent"].float().mean() > 0.5
    # Chains divergent at depth 0 keep their position.
    assert torch.all(out["samples"]["w"][0] == 0.0)

    nuts = TNUTS(step_size=1e-4, max_tree_depth=4)
    st = nuts.init({"w": torch.zeros(8, 2, dtype=torch.float64)},
                   n_chain_dims=1)
    _, out = nuts.run(_diag([1.0, 1.0]), {}, st, (6, 7), 5,
                      collect_fields=("depth", "n_leapfrogs", "turning"))
    # Tiny steps never turn: every tree is 2**4 - 1 = 15 new leaves.
    assert torch.all(out["depth"] == 4)
    assert torch.all(out["n_leapfrogs"] == 15)
    assert not out["turning"].any()


def test_run_thinned_equals_sliced_full_run():
    nuts = TNUTS(step_size=0.5, max_tree_depth=6, adapt_step_size=True)
    lj = _diag([1.0, 2.0])
    st = nuts.init({"w": torch.zeros(16, 2, dtype=torch.float64)},
                   n_chain_dims=1)
    full_st, full = nuts.run(lj, {}, st, (8, 9), 30, n_adapt=10)
    thin_st, thin = nuts.run(lj, {}, st, (8, 9), 30, n_adapt=10, thinning=4)
    assert thin["samples"]["w"].shape == (7, 16, 2)
    for f in thin:
        if f == "samples":
            assert torch.equal(thin[f]["w"], full[f]["w"][3::4])
        else:
            assert torch.equal(thin[f], full[f][3::4])
    # The remainder (30 = 7 * 4 + 2) still advances the final state.
    assert torch.equal(thin_st.q["w"], full_st.q["w"])
    assert thin_st.t == full_st.t == 30
    none_st, none = nuts.run(lj, {}, st, (8, 9), 30, n_adapt=10,
                             collect=False)
    assert none is None and torch.equal(none_st.q["w"], full_st.q["w"])


def test_run_collect_fields_and_validation():
    nuts = TNUTS(step_size=0.5)
    lj = _diag([1.0])
    st = nuts.init({"w": torch.zeros(4, 1, dtype=torch.float64)},
                   n_chain_dims=1)
    _, out = nuts.run(lj, {}, st, (1, 1), 3)
    assert set(out) == {"samples", "acceptance_rate", "step_size",
                        "log_prob", "depth", "divergent"}
    _, out = nuts.run(lj, {}, st, (1, 1), 3,
                      collect_fields=TNUTS._VALID_FIELDS)
    assert set(out) == set(TNUTS._VALID_FIELDS)
    assert out["samples"]["w"].shape == (3, 4, 1)
    assert out["step_size"].shape == (3,)
    for f in ("acceptance_rate", "log_prob", "energy"):
        assert out[f].shape == (3, 4) and out[f].dtype == torch.float64
    for f in ("depth", "n_leapfrogs"):
        assert out[f].dtype == torch.int32
    for f in ("divergent", "turning"):
        assert out[f].dtype == torch.bool
    with pytest.raises(ValueError, match="collect field"):
        nuts.run(lj, {}, st, (1, 1), 3, collect_fields=("bogus",))
    with pytest.raises(ValueError, match="thinning"):
        nuts.run(lj, {}, st, (1, 1), 3, thinning=0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(step_size=0.0), "step_size"),
    (dict(max_tree_depth=0), "max_tree_depth"),
    (dict(adapt_mass=True), "adapt_mass requires"),
    (dict(target_acceptance_rate=1.0), "target_acceptance_rate"),
    (dict(experimental_fused_step="yes"), "experimental_fused_step"),
])
def test_constructor_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        TNUTS(**kwargs)


def test_constructor_defaults_and_init():
    nuts = TNUTS()
    assert nuts.max_tree_depth == 10 and nuts.init_step_size == 0.1
    assert TNUTS(adapt_step_size=True).mass_collect_iters == 0
    st = nuts.init({"w": torch.zeros(3, 2, 4, dtype=torch.float64)},
                   log_joint=lambda obs: obs["w"].sum((-1, -2)))
    assert st.mass["w"].shape == (1, 2, 4) and st.t == 0
    with pytest.raises(ValueError):
        nuts.init({"w": torch.zeros(2, 3)})


def test_kernel_gate_on_the_cpu_and_its_reasons():
    lj = DiagonalGaussianLogJoint("x", torch.zeros(4), torch.ones(4))
    nuts = TNUTS(step_size=0.2, max_tree_depth=4,
                 experimental_fused_step=True)
    st = nuts.init({"x": torch.zeros(8, 4)}, log_joint=lj)
    before = fused_nuts_transition.launches
    st, info = nuts.sample(lj, {}, st, (1, 2))
    assert st.t == 1 and info.depth.shape == (8,)
    assert fused_nuts_transition.launches == before
    q = {"x": torch.zeros(8, 4)}
    m = {"x": torch.ones(1, 4)}
    ok = nuts._fused_ineligible
    assert ok(lj, {}, q, m, 1) is None
    assert "single" in ok(lj, {}, {**q, "y": q["x"]}, m, 1)
    assert "built-in" in ok(lambda o: o["x"].sum(-1), {}, q, m, 1)
    assert "latent" in ok(lj, {"x": 1}, q, m, 1)
    assert "float32" in ok(lj, {}, {"x": q["x"].to(torch.bfloat16)}, m, 1)
    assert "mass" in ok(lj, {}, q, {"x": torch.ones(8, 4)}, 1)
    deep = TNUTS(max_tree_depth=MAX_TREE_DEPTH + 1)
    assert "max_tree_depth" in deep._fused_ineligible(lj, {}, q, m, 1)


# --------------------------------------------------------------------- #
# ops/nuts_step.py: the gate, the wrapper, the plain version, the streams
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,depth,dtype,ok", [
    ((4096, 100), 6, torch.float32, True),
    ((4096, 100), 10, torch.float32, True),
    ((1000, 37), 8, None, True),
    ((8, MAX_DIM), MAX_TREE_DEPTH, torch.float32, True),
    ((8, MAX_DIM + 1), 6, torch.float32, False),
    ((8, 4), MAX_TREE_DEPTH + 1, torch.float32, False),
    ((8, 4), 0, torch.float32, False),
    ((8, 0), 6, torch.float32, False),
    ((4096,), 6, torch.float32, False),
    ((8, 4), 6, torch.bfloat16, False),
    ((8, 4), 6, torch.float64, False),
])
def test_nuts_step_supported(shape, depth, dtype, ok):
    assert nuts_step_supported(shape, depth, dtype) is ok


def _kernel_args(seed=0, c=16, d=5, depth=5, dtype=torch.float64):
    rs = np.random.RandomState(seed)
    dens = DiagonalGaussianLogJoint(
        "x", torch.as_tensor(0.3 * rs.randn(d), dtype=dtype),
        torch.as_tensor(rs.uniform(0.5, 1.5, d), dtype=dtype))
    q = torch.as_tensor(rs.randn(c, d), dtype=dtype)
    inv_mass = torch.as_tensor(rs.uniform(0.5, 2.0, (1, d)), dtype=dtype)
    return dens, q, inv_mass, 0.4, depth, 1000.0


def test_cpu_wrapper_runs_reference_without_counting():
    args = _kernel_args(1)
    before = fused_nuts_transition.launches
    got = fused_nuts_transition(*args, (3, 4), 7)
    want = fused_nuts_transition_reference(*args, (3, 4), 7)
    assert fused_nuts_transition.launches == before
    assert len(got) == 8
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_reference_draws_the_kernel_philox_stream():
    dens, q, inv_mass, step, depth, max_e = _kernel_args(2)
    key, t = (123, 456), 9
    got = fused_nuts_transition_reference(dens, q, inv_mass, step, depth,
                                          max_e, key, t)
    noise = nuts_noise(key, t, q.shape[0], q.shape[1], depth)
    want = nuts_transition(value_and_grad(dens.log_prob), q, inv_mass[0],
                           step, depth, max_e, noise)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    eps, u_dir, u_leaf, u_merge = noise
    assert torch.equal(eps, _random.philox_normal(
        key, t, q.shape, _random.STREAM_MOMENTUM))
    assert u_dir.shape == u_merge.shape == (16, depth)
    assert u_leaf.shape == (16, 2 ** depth - 1)
    other = fused_nuts_transition_reference(dens, q, inv_mass, step, depth,
                                            max_e, key, t + 1)
    assert not torch.equal(other[0], got[0])


def test_nuts_streams_layout_range_and_independence():
    key, t = (11, 22), 5
    streams = (_random.STREAM_NUTS_DIRECTION, _random.STREAM_NUTS_LEAF,
               _random.STREAM_NUTS_MERGE)
    # Clear of the MH stream and of the momentum streams of any latent
    # dict the HMC kernel takes (one latent).
    assert len(set(streams)) == 3
    assert min(streams) > _random.STREAM_MOMENTUM
    assert _random.STREAM_MH not in streams
    u = _random.philox_uniform_rows(key, t, (64, 37), _random.STREAM_NUTS_LEAF)
    assert u.shape == (64, 37) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # Column j is word j % 4 of group j // 4: a wider draw extends it.
    wide = _random.philox_uniform_rows(key, t, (64, 40),
                                       _random.STREAM_NUTS_LEAF)
    assert torch.equal(u, wide[:, :37])
    assert torch.equal(
        _random.philox_uniform_rows(key, t, (64, 37),
                                    _random.STREAM_NUTS_LEAF), u)
    words = _random.philox4x32_10(
        torch.tensor(t), torch.tensor(3), torch.tensor(2),
        torch.tensor(_random.STREAM_NUTS_LEAF), *key)
    assert float(u[3, 9]) == float(_random.uniform_from_bits(words[1]))
    # Distinct streams give distinct numbers on the same counters.
    draws = [_random.philox_uniform_rows(key, t, (64, 37), s)
             for s in streams + (_random.STREAM_MH,
                                 _random.STREAM_MOMENTUM)]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    big = _random.philox_uniform_rows((5, 6), 1, (4096, 64),
                                      _random.STREAM_NUTS_DIRECTION).double()
    assert abs(float(big.mean()) - 0.5) < 0.003
    assert abs(float(big.var()) - 1.0 / 12.0) < 0.002


def _refusal_args():
    dens, q, inv_mass, step, depth, max_e = _kernel_args(3)
    return dict(density=dens, q=q, inv_mass=inv_mass, step_size=step,
                max_tree_depth=depth, max_delta_energy=max_e, key=(1, 2),
                t=1)


@pytest.mark.parametrize("change,error", [
    (dict(density=lambda obs: obs["x"].sum(-1)), TypeError),
    (dict(q=torch.zeros(16, 5, 2, dtype=torch.float64)), ValueError),
    (dict(inv_mass=torch.ones(16, 5, dtype=torch.float64)), ValueError),
    (dict(density=DiagonalGaussianLogJoint(
        "x", torch.zeros(6), torch.ones(6))), ValueError),
    (dict(max_tree_depth=0), ValueError),
    (dict(q=torch.zeros(16, 5, device="meta"),
          inv_mass=torch.ones(1, 5, device="meta")), ValueError),
    (dict(inv_mass=torch.ones(1, 5, device="meta")), ValueError),
    (dict(noise=(torch.zeros(16, 5), torch.zeros(16, 5),
                 torch.zeros(16, 31), torch.zeros(16, 5))), None),
    (dict(noise=(torch.zeros(16, 5), torch.zeros(16, 5),
                 torch.zeros(16, 30), torch.zeros(16, 5))), ValueError),
])
def test_wrapper_refuses(change, error):
    args = _refusal_args()
    args.update(change)
    noise = args.pop("noise", None)
    if error is None:  # well-formed noise is taken
        fused_nuts_transition(*args.values(), noise=noise)
        return
    with pytest.raises(error):
        fused_nuts_transition(*args.values(), noise=noise)


# --------------------------------------------------------------------- #
# On the card only: the CUDA kernel against its plain version.
# --------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 6, 10])
def test_kernel_matches_reference_on_card(depth):
    _need_cuda()
    dev = torch.device("cuda")
    dens, q, inv_mass, step, _, max_e = _kernel_args(
        8, c=256, d=37, dtype=torch.float32)
    dens = DiagonalGaussianLogJoint("x", dens.loc.to(dev),
                                    dens.scale.to(dev))
    q, inv_mass = q.to(dev), inv_mass.to(dev)
    before = fused_nuts_transition.launches
    got = fused_nuts_transition(dens, q, inv_mass, step, depth, max_e,
                                (1, 2), 3)
    torch.cuda.synchronize()
    assert fused_nuts_transition.launches == before + 1
    want = fused_nuts_transition_reference(dens, q, inv_mass, step, depth,
                                           max_e, (1, 2), 3)
    tree = [torch.equal(g, w) for g, w in zip(got[4:], want[4:])]
    same = ((got[4] == want[4]) & (got[5] == want[5])
            & (got[6] == want[6]) & (got[7] == want[7]))
    assert int((~same).sum()) <= 1, tree
    for g, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(g[same], w[same], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_true_raises_on_ineligible_cuda_input():
    _need_cuda()
    dev = torch.device("cuda")
    nuts = TNUTS(step_size=0.1, max_tree_depth=4,
                 experimental_fused_step=True)
    st = nuts.init({"x": torch.zeros(16, 4, device=dev)}, n_chain_dims=1)
    with pytest.raises(ValueError):
        nuts.sample(lambda obs: -0.5 * (obs["x"] ** 2).sum(-1), {}, st,
                    (1, 2))


# --------------------------------------------------------------------- #
# The smoke script imports nothing of JAX either
# --------------------------------------------------------------------- #
def test_chip_smoke_never_imports_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "zhusuan_tpu_torch" in names or any(
        n.startswith("zhusuan_tpu_torch.") for n in names)
    bad = [n for n in names if n == "jax" or n.startswith("jax.")
           or n == "zhusuan_tpu" or n.startswith("zhusuan_tpu.")]
    assert not bad, bad
