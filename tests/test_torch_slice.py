"""Parity of the port's slice sampler (``zhusuan_tpu_torch/mcmc/
slice_sampler.py``) with ``zhusuan_tpu/mcmc/slice_sampler.py`` in float64 on
the CPU, on the JAX draws: JAX ``run`` splits ``k, sub = split(k)`` a
sweep; the sweep threads ``sub`` through its coordinates, each splitting
``k, k_y, k_pos, k_split, k_shrink = split(k, 5)`` (the slice height's
open-interval uniform, the interval position's uniform, the budget split
``randint(0, max_stepouts)``) and the ``i``-th shrink ``kk, k_u = split(kk)``
from ``k_shrink``, which the port takes as ``noise=``. One sweep and 30
chained sweeps (15 adapting the widths) at 1e-8, with equal stuck
fractions, at the defaults and at caps small enough that chains get stuck;
thinning against the sliced full run; the loop run to its caps gives the
same draws; the validation errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.distributions.utils import (
    open_interval_standard_uniform as j_open_uniform,
)
from zhusuan_tpu.mcmc import SliceSampler as JSlice
from zhusuan_tpu_torch.mcmc import SliceSampler

TOL = 1e-8
N_CHAINS = 5
_RNG = np.random.default_rng(21)


def j_lj(obs):
    a = jnp.sum(-0.5 * ((obs["a"] - 1.0) / jnp.array([0.3, 2.0])) ** 2, -1)
    return a - jnp.abs(obs["b"] + 0.5) - 0.2 * obs["a"][..., 0] * obs["b"]


def t_lj(obs):
    a = torch.sum(-0.5 * ((obs["a"] - 1.0) / torch.tensor(
        [0.3, 2.0], dtype=torch.float64)) ** 2, -1)
    return a - torch.abs(obs["b"] + 0.5) - 0.2 * obs["a"][..., 0] * obs["b"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _noise(key, total, chain_shape, m, n_shrinks):
    u_y, u_pos, budget, shrink = [], [], [], []
    k = key
    for _ in range(total):
        k, k_y, k_pos, k_split, k_shrink = jax.random.split(k, 5)
        u_y.append(j_open_uniform(k_y, chain_shape, jnp.float64))
        u_pos.append(jax.random.uniform(k_pos, chain_shape, jnp.float64))
        budget.append(jax.random.randint(k_split, chain_shape, 0, m))
        rows, kk = [], k_shrink
        for _ in range(n_shrinks):
            kk, k_u = jax.random.split(kk)
            rows.append(jax.random.uniform(k_u, chain_shape, jnp.float64))
        shrink.append(np.stack(rows))
    return (np.stack(u_y), np.stack(u_pos), np.stack(budget),
            np.stack(shrink))


CAPS = {"defaults": {}, "tight": {"max_stepouts": 3, "max_shrinks": 2}}


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_one_sweep_and_30_sweeps(caps):
    kw = dict(width={"a": np.array([0.5, 1.0]), "b": 0.7}, adapt_width=True,
              **CAPS[caps])
    j = JSlice(**kw)
    t = SliceSampler(**kw)
    m = kw.get("max_stepouts", 8)
    n_shrinks = kw.get("max_shrinks", 32)
    q0 = {"a": _RNG.standard_normal((N_CHAINS, 2)),
          "b": _RNG.standard_normal(N_CHAINS)}
    key = jax.random.PRNGKey(8)
    js0 = j.init({k: jnp.asarray(v) for k, v in q0.items()}, 1)
    ts0 = t.init({k: torch.tensor(v) for k, v in q0.items()}, 1)
    _close(ts0.width, js0.width)
    jn, jinfo = j.sample(j_lj, {}, js0, key, adapt=True)
    tn, tinfo = t.sample(t_lj, {}, ts0, adapt=True,
                         noise=_noise(key, 3, (N_CHAINS,), m, n_shrinks))
    for k in q0:
        _close(tn.q[k], jn.q[k])
    _close(tn.width, jn.width)
    _close(tinfo.stuck_fraction, jinfo.stuck_fraction)

    n_iters = 30
    _, jout = j.run(j_lj, {}, js0, key, n_iters, n_adapt=15,
                    collect_fields=("samples", "log_prob", "width",
                                    "stuck_fraction"))
    noise, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        noise.append(_noise(sub, 3, (N_CHAINS,), m, n_shrinks))
    tst, tout = t.run(t_lj, {}, ts0, None, n_iters, n_adapt=15,
                      collect_fields=("samples", "log_prob", "width",
                                      "stuck_fraction"), noise=noise)
    for n in q0:
        _close(tout["samples"][n], jout["samples"][n])
    for f in ("log_prob", "width", "stuck_fraction"):
        _close(tout[f], jout[f])
    assert tst.t == n_iters
    stuck = float(tout["stuck_fraction"].sum())
    assert (stuck > 0) == (caps == "tight")


class _ToTheCap(SliceSampler):
    """Both loops run every chain to its cap (a finished chain frozen)."""

    @staticmethod
    def _any(flags):
        return True


def test_thinning_and_loop_to_cap():
    t = SliceSampler(width=0.8, max_shrinks=6)
    st = t.init({"a": torch.zeros(N_CHAINS, 2, dtype=torch.float64),
                 "b": torch.zeros(N_CHAINS, dtype=torch.float64)}, 1)
    key = (5, 6)
    full_st, full = t.run(t_lj, {}, st, key, 9,
                          collect_fields=("samples", "stuck_fraction"))
    thin_st, thin = t.run(t_lj, {}, st, key, 9, thinning=4)
    for n in st.q:
        assert torch.equal(thin["samples"][n], full["samples"][n][3::4])
        assert torch.equal(thin_st.q[n], full_st.q[n])
    cap_st, cap = _ToTheCap(width=0.8, max_shrinks=6).run(
        t_lj, {}, st, key, 9, collect_fields=("samples", "stuck_fraction"))
    for n in st.q:
        assert torch.equal(cap["samples"][n], full["samples"][n])
    assert torch.equal(cap["stuck_fraction"], full["stuck_fraction"])
    assert bool(torch.isnan(full_st.invalidate_cache().log_prob).all())


def test_validation_errors():
    with pytest.raises(ValueError, match="width"):
        SliceSampler(width=0.0)
    with pytest.raises(ValueError, match="positive everywhere"):
        SliceSampler(width={"a": np.array([1.0, 0.0])})
    with pytest.raises(ValueError, match="max_stepouts"):
        SliceSampler(max_shrinks=0)
    t = SliceSampler(width={"a": 1.0})
    with pytest.raises(ValueError, match="missing"):
        t.init({"a": torch.zeros(3, 2), "b": torch.zeros(3)}, 1)
    with pytest.raises(ValueError, match="chain shape"):
        SliceSampler().init({"a": torch.zeros(3, 2), "b": torch.zeros(4)}, 1)
    with pytest.raises(TypeError, match="n_chain_dims"):
        SliceSampler().init({"a": torch.zeros(3, 2)}, 1.0)
    st = SliceSampler().init({"b": torch.zeros(3, dtype=torch.float64)}, 1)
    with pytest.raises(ValueError, match="collect field"):
        SliceSampler().run(lambda o: -o["b"] ** 2, {}, st, (1, 2), 2,
                           collect_fields=("nope",))
