"""Parity of the port's elliptical slice sampler (``zhusuan_tpu_torch/mcmc/
elliptical.py``) with ``zhusuan_tpu/mcmc/elliptical.py`` in float64 on the
CPU: 30 transitions on the JAX draws at 1e-10 with equal shrink counts.
The JAX ``run`` splits ``k, sub = split(k)`` an iteration; ``sample(sub)``
splits ``key_nu, key_u, key_theta, key_shrink = split(sub, 4)``: the unit
normals ``tree_normal_like(key_nu, f)``, the slice uniform, the angle
``uniform(key_theta, minval=0, maxval=2 pi)`` and the ``i``-th shrink's
``uniform(fold_in(key_shrink, i))``, which the port takes as ``noise=``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc import EllipticalSlice as JESS
from zhusuan_tpu.mcmc.base import tree_normal_like as j_tree_normal_like
from zhusuan_tpu_torch.mcmc import EllipticalSlice
from zhusuan_tpu_torch.mcmc import elliptical

torch.set_num_threads(1)

TOL = 1e-10
MAX_SHRINK = 64
N_CHAINS, D = 6, 5
_RNG = np.random.default_rng(0)
_XS = np.sort(_RNG.uniform(-1, 1, D))
_K = np.exp(-0.5 * (_XS[:, None] - _XS[None, :]) ** 2 / 0.3) + 1e-6 * np.eye(D)
CHOL = np.linalg.cholesky(_K)
YF = np.where(_RNG.uniform(size=D) < 0.5, 1.0, -1.0)
YG = np.array([0.7, -1.2])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def j_log_lik(obs):
    return (jnp.sum(jax.nn.log_sigmoid(3.0 * YF * obs["f"]), axis=-1)
            - 0.5 * jnp.sum((obs["g"] - YG) ** 2 / 0.25, axis=-1))


def t_log_lik(obs):
    return (torch.sum(torch.nn.functional.logsigmoid(
        3.0 * torch.tensor(YF) * obs["f"]), dim=-1)
        - 0.5 * torch.sum((obs["g"] - torch.tensor(YG)) ** 2 / 0.25, dim=-1))


def _noise(key, f, chain_shape):
    """The draws JAX's ``sample(key)`` makes, as the port's ``noise=``."""
    key_nu, key_u, key_theta, key_shrink = jax.random.split(key, 4)
    nu = {k: np.array(v) for k, v in j_tree_normal_like(key_nu, f).items()}
    u = jax.random.uniform(key_u, chain_shape, jnp.float64)
    theta = jax.random.uniform(key_theta, chain_shape, jnp.float64, 0.0,
                               2.0 * jnp.pi)
    shrink = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key_shrink, i), chain_shape, jnp.float64))
        for i in range(MAX_SHRINK)])
    return nu, np.asarray(u), np.asarray(theta), shrink


def _samplers(prior_std):
    return (JESS(prior_std=prior_std, prior_chol={"f": jnp.asarray(CHOL)},
                 max_shrink=MAX_SHRINK),
            EllipticalSlice(prior_std=prior_std,
                            prior_chol={"f": torch.tensor(CHOL)},
                            max_shrink=MAX_SHRINK))


@pytest.mark.parametrize("prior_std", [1.3, {"g": np.array([0.5, 2.0])}])
def test_30_transitions(prior_std):
    j, t = _samplers(prior_std)
    f0 = {"f": np.zeros((N_CHAINS, D)), "g": np.zeros((N_CHAINS, 2))}
    n_iters = 30
    key = jax.random.PRNGKey(7)
    _, jout = j.run(j_log_lik, {}, j.init(f0, n_chain_dims=1), key,
                    n_iters=n_iters)
    # JAX's per-iteration keys, and the positions each iteration starts at.
    keys, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        keys.append(sub)
    starts = [f0] + [{n: np.asarray(v[i]) for n, v in jout["samples"].items()}
                     for i in range(n_iters - 1)]
    noise = [_noise(kk, s, (N_CHAINS,)) for kk, s in zip(keys, starts)]
    tstate = t.init({n: torch.tensor(v) for n, v in f0.items()},
                    n_chain_dims=1)
    tstate, tout = t.run(t_log_lik, {}, tstate, None, n_iters, noise=noise)
    for n in f0:
        _close(tout["samples"][n], jout["samples"][n])
    _close(tout["log_lik"], jout["log_lik"])
    assert tout["n_shrinks"].tolist() == np.asarray(jout["n_shrinks"]).tolist()
    assert tstate.t == n_iters
    assert int(tout["n_shrinks"].sum()) > n_iters  # some iterations shrank


def test_nan_cache_and_stale_cache():
    j, t = _samplers(1.0)
    f0 = {"f": _RNG.standard_normal((N_CHAINS, D)) * 0.3,
          "g": _RNG.standard_normal((N_CHAINS, 2))}
    key = jax.random.PRNGKey(9)
    noise = _noise(key, f0, (N_CHAINS,))
    tf0 = {n: torch.tensor(v) for n, v in f0.items()}
    # The init sentinel (NaN) makes sample evaluate the likelihood.
    js = j.init(f0, n_chain_dims=1)
    ts = t.init(tf0, n_chain_dims=1)
    assert bool(torch.isnan(ts.log_lik).all())
    jn, jinfo = j.sample(j_log_lik, {}, js, key)
    tn, tinfo = t.sample(t_log_lik, {}, ts, noise=noise)
    _close(tn.log_lik, jn.log_lik)
    assert tinfo.n_shrinks == int(jinfo.n_shrinks)
    # A finite stale cache is used as it stands (no re-evaluation) ...
    stale = np.full(N_CHAINS, -50.0)
    jn, _ = j.sample(j_log_lik, {}, js._replace(log_lik=jnp.asarray(stale)),
                     key)
    tn, _ = t.sample(t_log_lik, {}, ts._replace(log_lik=torch.tensor(stale)),
                     noise=noise)
    for n in f0:
        _close(tn.f[n], jn.f[n])
    # ... until invalidate_cache puts the sentinel back.
    ts2 = ts._replace(log_lik=torch.tensor(stale)).invalidate_cache()
    js2 = js._replace(log_lik=jnp.asarray(stale)).invalidate_cache()
    assert bool(torch.isnan(ts2.log_lik).all())
    jn, _ = j.sample(j_log_lik, {}, js2, key)
    tn, _ = t.sample(t_log_lik, {}, ts2, noise=noise)
    for n in f0:
        _close(tn.f[n], jn.f[n])


def test_max_shrink_stays_put():
    # A threshold no proposal meets: every chain stays where it was after
    # max_shrink shrinks.
    t = EllipticalSlice(prior_std=1.0, max_shrink=3)
    ts = t.init({"g": torch.ones(4, 2, dtype=torch.float64)}, n_chain_dims=1)
    ts = ts._replace(log_lik=torch.full((4,), 1e9, dtype=torch.float64))
    g = torch.Generator().manual_seed(0)
    tn, info = t.sample(lambda o: -torch.sum(o["g"] ** 2, dim=-1), {}, ts, g)
    assert info.n_shrinks == 3
    assert torch.equal(tn.f["g"], ts.f["g"])


def test_own_draws_state_round_trip_and_errors():
    _, t = _samplers(1.0)
    f0 = {"f": torch.zeros(N_CHAINS, D, dtype=torch.float64),
          "g": torch.zeros(N_CHAINS, 2, dtype=torch.float64)}
    g = torch.Generator().manual_seed(1)
    ts, out = t.run(t_log_lik, {}, t.init(f0, n_chain_dims=1), g, 5)
    assert out["samples"]["f"].shape == (5, N_CHAINS, D)
    assert bool(torch.isfinite(out["log_lik"]).all())
    back = elliptical.state_from_numpy(elliptical.state_to_numpy(ts),
                                       device="cpu")
    assert back.t == ts.t == 5
    for n in f0:
        assert torch.equal(back.f[n], ts.f[n])
    assert torch.equal(back.log_lik, ts.log_lik)
    jstate = JESS(prior_std=1.0).init({"g": np.ones((3, 2))}, 1)
    from_jax = elliptical.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           device="cpu")
    assert from_jax.t == 0 and bool(torch.isnan(from_jax.log_lik).all())
    with pytest.raises(ValueError, match="max_shrink"):
        EllipticalSlice(max_shrink=0)
    with pytest.raises(KeyError, match="No prior_std"):
        EllipticalSlice(prior_std={"a": 1.0}).init({"b": torch.zeros(2, 3)},
                                                   1)
    with pytest.raises(TypeError, match="n_chain_dims"):
        EllipticalSlice().init({"b": torch.zeros(2, 3)}, 1.0)
    with pytest.raises(ValueError, match="Generator or noise"):
        t.sample(t_log_lik, {}, t.init(f0, 1))
