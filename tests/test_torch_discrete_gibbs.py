"""Parity of the port's exact discrete Gibbs (``zhusuan_tpu_torch/mcmc/
discrete.py``) with ``zhusuan_tpu/mcmc/discrete.py`` in float64 on the CPU,
on the JAX draws: a sweep splits its key over the latents (sorted names),
each latent's key over its coordinates, and coordinate ``j`` draws
``categorical(k_j, scores, axis=0)``, the arg-max of the scores plus
``gumbel(k_j, [K, *chain_shape])``, which the port takes as ``noise=``.
One sweep and 30 chained sweeps at 1e-8 (the labels equal), thinning
against the sliced full run, and the validation errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc import DiscreteGibbs as JDiscrete
from zhusuan_tpu_torch.mcmc import DiscreteGibbs

TOL = 1e-8
N_CHAINS = 7
_YS = np.array([0.9, -0.4, 0.5])
_W = np.array([[0.2, -0.1, 0.4], [0.0, 0.3, -0.2]])
SUPPORT = {"x": np.array([0.0, 1.0]), "z": np.array([-1.0, 0.0, 2.0])}


def j_lj(obs):
    x, z = obs["x"], obs["z"]  # [..., 3], [..., 2]
    prior = jnp.sum(x * jnp.log(0.3) + (1.0 - x) * jnp.log(0.7), axis=-1)
    mean = x + jnp.einsum("...k,kj->...j", z, jnp.asarray(_W))
    return prior - 0.1 * jnp.sum(z ** 2, -1) - 0.5 * jnp.sum(
        ((jnp.asarray(_YS) - mean) / 0.8) ** 2, axis=-1)


def t_lj(obs):
    x, z = obs["x"], obs["z"]
    prior = torch.sum(x * np.log(0.3) + (1.0 - x) * np.log(0.7), dim=-1)
    mean = x + torch.einsum("...k,kj->...j", z, torch.tensor(_W))
    return prior - 0.1 * torch.sum(z ** 2, -1) - 0.5 * torch.sum(
        ((torch.tensor(_YS) - mean) / 0.8) ** 2, dim=-1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _noise(key, q):
    out = {}
    names = sorted(q)
    for name, k in zip(names, jax.random.split(key, len(names))):
        n_coords = q[name].shape[-1]
        shape = (len(SUPPORT[name]), N_CHAINS)
        out[name] = np.stack([
            np.array(jax.random.gumbel(kj, shape, jnp.float64))
            for kj in jax.random.split(k, n_coords)])
    return out


def _init():
    rng = np.random.default_rng(4)
    return {"x": rng.integers(0, 2, (N_CHAINS, 3)).astype(np.float64),
            "z": rng.choice(SUPPORT["z"], (N_CHAINS, 2))}


def test_one_sweep_and_30_sweeps():
    j = JDiscrete({k: jnp.asarray(v) for k, v in SUPPORT.items()})
    t = DiscreteGibbs({k: torch.tensor(v) for k, v in SUPPORT.items()})
    q0 = _init()
    key = jax.random.PRNGKey(6)
    js0 = j.init({k: jnp.asarray(v) for k, v in q0.items()}, 1)
    ts0 = t.init({k: torch.tensor(v) for k, v in q0.items()}, 1)
    jn, jinfo = j.sample(j_lj, {}, js0, key)
    tn, tinfo = t.sample(t_lj, {}, ts0, noise=_noise(key, q0))
    for k in q0:
        _close(tn.q[k], jn.q[k])
    _close(tinfo.log_prob, jinfo.log_prob)

    n_iters = 30
    _, jout = j.run(j_lj, {}, js0, key, n_iters)
    noise, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        noise.append(_noise(sub, q0))
    tst, tout = t.run(t_lj, {}, ts0, None, n_iters, noise=noise)
    for n in q0:
        _close(tout["samples"][n], jout["samples"][n])
        # Many label changes, not a frozen chain.
        assert bool((tout["samples"][n][1:] != tout["samples"][n][:-1])
                    .any())
    _close(tout["log_prob"], jout["log_prob"])
    assert tst.t == n_iters


def test_thinning_and_errors():
    t = DiscreteGibbs({k: torch.tensor(v) for k, v in SUPPORT.items()})
    st = t.init({k: torch.tensor(v) for k, v in _init().items()}, 1)
    assert st.invalidate_cache() is st
    full_st, full = t.run(t_lj, {}, st, (9, 9), 8)
    thin_st, thin = t.run(t_lj, {}, st, (9, 9), 8, thinning=3,
                          collect_fields=("samples",))
    assert set(thin) == {"samples"}
    for n in st.q:
        assert torch.equal(thin["samples"][n], full["samples"][n][2::3])
        assert torch.equal(thin_st.q[n], full_st.q[n])
    with pytest.raises(ValueError, match="at least one"):
        DiscreteGibbs({})
    with pytest.raises(ValueError, match=">= 2 values"):
        DiscreteGibbs({"x": torch.tensor([1.0])})
    with pytest.raises(ValueError, match="exactly cover"):
        t.init({"x": torch.zeros(2, 3)}, 1)
    with pytest.raises(TypeError, match="n_chain_dims"):
        t.init({k: torch.tensor(v) for k, v in _init().items()}, 1.0)
    with pytest.raises(ValueError, match="collect field"):
        t.run(t_lj, {}, st, (1, 2), 2, collect_fields=("nope",))
