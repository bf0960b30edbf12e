"""Parity of the port's replica-exchange HMC (``zhusuan_tpu_torch/mcmc/
remc.py``) with ``zhusuan_tpu/mcmc/remc.py`` in float64 on the CPU, on the
JAX draws: JAX ``run`` splits ``k, sub = split(k)`` an iteration;
``sample(sub)`` splits ``key_p, key_u, key_s = split(sub, 3)``, the momenta
``tree_normal_like(key_p, q)`` (sorted names, ``[n_temps, n_chains, ...]``),
the MH and the swap uniforms (``[n_temps, n_chains]`` each), which the port
takes as ``noise=``. One iteration and 30 chained ones (15 adapting the
per-rung step sizes) at 1e-8 on ``tests/test_remc.py``'s two-mode target,
with an even/odd swap schedule every second iteration; the validation
errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc import ReplicaExchangeHMC as JREMC
from zhusuan_tpu.mcmc.base import tree_normal_like as j_tree_normal_like
from zhusuan_tpu_torch.mcmc import ReplicaExchangeHMC

TOL = 1e-8
MU = 4.0
N_TEMPS, N_CHAINS = 4, 6


def j_lj(obs):
    z = obs["z"]
    return jnp.logaddexp(-0.5 * jnp.sum((z - MU) ** 2, -1),
                         -0.5 * jnp.sum((z + MU) ** 2, -1)) \
        - 0.5 * obs["w"] ** 2


def t_lj(obs):
    z = obs["z"]
    return torch.logaddexp(-0.5 * torch.sum((z - MU) ** 2, -1),
                           -0.5 * torch.sum((z + MU) ** 2, -1)) \
        - 0.5 * obs["w"] ** 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _noise(key, q):
    key_p, key_u, key_s = jax.random.split(key, 3)
    p = {k: np.array(v) for k, v in j_tree_normal_like(key_p, q).items()}
    shape = (N_TEMPS, N_CHAINS)
    return (p, np.array(jax.random.uniform(key_u, shape, jnp.float64)),
            np.array(jax.random.uniform(key_s, shape, jnp.float64)))


def test_one_iteration_and_30_iterations():
    kw = dict(step_size=0.4, n_leapfrogs=5, n_temps=N_TEMPS, min_beta=0.05,
              swap_every=2)
    j, t = JREMC(**kw), ReplicaExchangeHMC(**kw)
    rng = np.random.default_rng(3)
    q0 = {"z": MU + rng.standard_normal((N_CHAINS, 2)),
          "w": rng.standard_normal(N_CHAINS)}
    key = jax.random.PRNGKey(13)
    js0 = j.init({k: jnp.asarray(v) for k, v in q0.items()}, j_lj)
    ts0 = t.init({k: torch.tensor(v) for k, v in q0.items()}, t_lj)
    assert ts0.q["z"].shape == (N_TEMPS, N_CHAINS, 2)
    _close(ts0.base_lp, js0.base_lp)
    _close(ts0.step_size, js0.step_size)
    q0r = {k: np.asarray(v) for k, v in js0.q.items()}
    jn, jinfo = j.sample(j_lj, {}, js0, key)
    tn, tinfo = t.sample(t_lj, {}, ts0, noise=_noise(key, q0r))
    for k in q0:
        _close(tn.q[k], jn.q[k])
    for f in ("acceptance_rate", "swap_rate", "step_size", "log_prob"):
        _close(getattr(tinfo, f), getattr(jinfo, f))

    n_iters = 30
    jst, jout = j.run(j_lj, {}, js0, key, n_iters, n_adapt=15)
    # The momentum draws depend on the replicas' shapes only.
    noise, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        noise.append(_noise(sub, q0r))
    tst, tout = t.run(t_lj, {}, ts0, None, n_iters, n_adapt=15, noise=noise)
    for n in q0:
        _close(tout["samples"][n], jout["samples"][n])
        _close(tst.q[n], jst.q[n])
    for f in ("acceptance_rate", "swap_rate", "log_prob"):
        _close(tout[f], jout[f])
    for f in ("base_lp", "step_size", "da_step", "h_bar", "log_epsilon_bar"):
        _close(getattr(tst, f), getattr(jst, f))
    assert tst.t == n_iters
    # Swaps happened, on alternating rounds only.
    rates = _np(tout["swap_rate"])
    assert np.isnan(rates[1::2]).all() and np.nansum(rates) > 0


def test_own_draws_and_errors():
    t = ReplicaExchangeHMC(step_size=0.3, n_leapfrogs=3, n_temps=3)
    st = t.init({"z": torch.zeros(4, 2, dtype=torch.float64),
                 "w": torch.zeros(4, dtype=torch.float64)}, t_lj)
    a_st, a = t.run(t_lj, {}, st, (4, 5), 5, n_adapt=2)
    b_st, b = t.run(t_lj, {}, st, (4, 5), 5, n_adapt=2)
    assert torch.equal(a["samples"]["z"], b["samples"]["z"])
    assert a["swap_rate"].shape == (5, 2)
    none_st, none = t.run(t_lj, {}, st, (4, 5), 5, n_adapt=2, collect=False)
    assert none is None and torch.equal(none_st.q["z"], a_st.q["z"])
    with pytest.raises(ValueError, match="strictly decrease"):
        ReplicaExchangeHMC(betas=[1.0, 0.5, 0.7])
    with pytest.raises(ValueError, match="start at 1.0"):
        ReplicaExchangeHMC(betas=[0.9, 0.5])
    ladder = ReplicaExchangeHMC(n_temps=5, min_beta=0.1).betas
    np.testing.assert_allclose(ladder[[0, -1]], [1.0, 0.1])
