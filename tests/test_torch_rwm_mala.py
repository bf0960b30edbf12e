"""Parity of the port's RWM and MALA (``zhusuan_tpu_torch/mcmc/rwm.py``)
with ``zhusuan_tpu/mcmc/rwm.py`` in float64 on the CPU, on the JAX draws:
JAX ``run`` splits ``k, sub = split(k)`` an iteration; ``sample(sub)``
splits ``key_prop, key_mh = split(sub)``, the proposal normals
``tree_normal_like(key_prop, q)`` (sorted-name order) and the MH uniform
``uniform(key_mh, chain_shape)``, which the port takes as ``noise=``. One
transition and 30 chained iterations (15 adapting) at 1e-8; thinning
against the sliced full run; the cache sentinel; the validation errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc import MALA as JMALA
from zhusuan_tpu.mcmc import RandomWalkMetropolis as JRWM
from zhusuan_tpu.mcmc.base import tree_normal_like as j_tree_normal_like
from zhusuan_tpu_torch.mcmc import MALA, RandomWalkMetropolis

TOL = 1e-8
N_CHAINS = 6
_RNG = np.random.default_rng(11)
_MU = _RNG.standard_normal(3)
_SD = np.array([0.5, 1.0, 2.0])


def j_lj(obs):
    a = jnp.sum(-0.5 * ((obs["a"] - _MU) / _SD) ** 2, axis=-1)
    return a - 0.5 * (obs["b"] - 1.0) ** 2 - 0.1 * obs["b"] ** 4


def t_lj(obs):
    a = torch.sum(-0.5 * ((obs["a"] - torch.tensor(_MU)) /
                          torch.tensor(_SD)) ** 2, dim=-1)
    return a - 0.5 * (obs["b"] - 1.0) ** 2 - 0.1 * obs["b"] ** 4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _noise(key, q, chain_shape):
    key_prop, key_mh = jax.random.split(key)
    xi = {k: np.asarray(v) for k, v in j_tree_normal_like(key_prop, q).items()}
    return xi, np.array(jax.random.uniform(key_mh, chain_shape,
                                             jnp.float64))


def _init():
    return {"a": _RNG.standard_normal((N_CHAINS, 3)),
            "b": _RNG.standard_normal(N_CHAINS)}


PAIRS = {"rwm": (JRWM, RandomWalkMetropolis, 0.6),
         "mala": (JMALA, MALA, 0.4)}


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_one_transition_and_30_iterations(kind):
    jcls, tcls, step = PAIRS[kind]
    j = jcls(step_size=step, adapt_step_size=True)
    t = tcls(step_size=step, adapt_step_size=True)
    q0 = _init()
    key = jax.random.PRNGKey(5)
    js0 = j.init({k: jnp.asarray(v) for k, v in q0.items()}, n_chain_dims=1)
    ts0 = t.init({k: torch.tensor(v) for k, v in q0.items()}, n_chain_dims=1)
    jn, jinfo = j.sample(j_lj, {}, js0, key)
    tn, tinfo = t.sample(t_lj, {}, ts0, noise=_noise(key, q0, (N_CHAINS,)))
    for k in q0:
        _close(tn.q[k], jn.q[k])
        if kind == "mala":
            _close(tn.grad[k], jn.grad[k])
    _close(tinfo.acceptance_rate, jinfo.acceptance_rate)
    _close(tn.step_size, jn.step_size)
    _close(tn.log_prob, jn.log_prob)

    n_iters = 30
    _, jout = j.run(j_lj, {}, js0, key, n_iters, n_adapt=15)
    keys, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        keys.append(sub)
    starts = [q0] + [{n: np.asarray(v[i]) for n, v in jout["samples"].items()}
                     for i in range(n_iters - 1)]
    noise = [_noise(kk, s, (N_CHAINS,)) for kk, s in zip(keys, starts)]
    tst, tout = t.run(t_lj, {}, ts0, None, n_iters, n_adapt=15, noise=noise)
    for n in q0:
        _close(tout["samples"][n], jout["samples"][n])
    for f in ("acceptance_rate", "step_size", "log_prob"):
        _close(tout[f], jout[f])
    assert tst.t == n_iters
    # Adaptation stopped at t = 15: the step size is constant after.
    assert torch.all(tout["step_size"][15:] == tout["step_size"][15])


def test_thinning_and_cache():
    t = MALA(step_size=0.3, adapt_step_size=True)
    st = t.init({k: torch.tensor(v) for k, v in _init().items()}, 1)
    key = (3, 4)
    full_st, full = t.run(t_lj, {}, st, key, 10, n_adapt=4)
    thin_st, thin = t.run(t_lj, {}, st, key, 10, n_adapt=4, thinning=3,
                          collect_fields=("samples", "step_size"))
    assert set(thin) == {"samples", "step_size"}
    for n in st.q:
        assert torch.equal(thin["samples"][n], full["samples"][n][2::3])
        assert torch.equal(thin_st.q[n], full_st.q[n])
    assert torch.equal(thin["step_size"], full["step_size"][2::3])
    none_st, none = t.run(t_lj, {}, st, key, 10, n_adapt=4, collect=False)
    assert none is None and torch.equal(none_st.q["a"], full_st.q["a"])
    # A stale finite cache is used as it stands; invalidate_cache makes the
    # next step re-evaluate.
    t = MALA(step_size=0.3)
    full_st, _ = t.run(t_lj, {}, st, key, 10)
    stale = full_st._replace(log_prob=torch.full((N_CHAINS,), 1e6,
                                                 dtype=torch.float64))
    a, _ = t.sample(t_lj, {}, stale, key)
    b, _ = t.sample(t_lj, {}, stale.invalidate_cache(), key)
    c, _ = t.sample(t_lj, {}, full_st, key)
    assert torch.equal(b.q["a"], c.q["a"]) and not torch.equal(a.q["a"],
                                                                c.q["a"])
    assert bool(torch.isnan(stale.invalidate_cache().log_prob).all())


def test_validation_errors():
    with pytest.raises(ValueError, match="step_size"):
        RandomWalkMetropolis(step_size=0.0)
    with pytest.raises(ValueError, match="target_acceptance_rate"):
        MALA(target_acceptance_rate=1.0)
    t = RandomWalkMetropolis()
    with pytest.raises(TypeError, match="n_chain_dims"):
        t.init({"b": torch.zeros(3)}, 1.0)
    st = t.init({"b": torch.zeros(3, dtype=torch.float64)}, 1)
    with pytest.raises(ValueError, match="collect field"):
        t.run(lambda o: -o["b"] ** 2, {}, st, (1, 2), 2,
              collect_fields=("nope",))
    with pytest.raises(ValueError, match="thinning"):
        t.run(lambda o: -o["b"] ** 2, {}, st, (1, 2), 2, thinning=0)
