"""Parity of the port's block-wise Gibbs (``zhusuan_tpu_torch/mcmc/
gibbs.py``) with ``zhusuan_tpu/mcmc/gibbs.py`` in float64 on the CPU, on the
JAX draws. A JAX sweep splits its key over the components; here
``DiscreteGibbs`` on the labels ``x``, an adapting ``HMC`` on ``mu``
(``split(k, 3) -> key_p, key_u, key_j``: momentum normals, MH uniforms),
an adapting RWM on ``s`` (``key_prop, key_mh``) and a width-adapting slice
sampler on ``c`` (its per-coordinate splits), each fed to the port's
component as its ``noise``. One sweep and 30 chained sweeps (15 adapting)
at 1e-8; every component's tuning state; thinning against the sliced full
run; the dispatch's ``TypeError`` and the validation errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu.mcmc as jm
from zhusuan_tpu.mcmc.base import tree_normal_like as j_tree_normal_like
from zhusuan_tpu_torch import mcmc as tm

from tests.test_torch_slice import _noise as _slice_noise

TOL = 1e-8
N_CHAINS = 6
_Y = np.array([1.3, -0.2])


def j_lj(obs):
    x, mu, s, c = obs["x"], obs["mu"], obs["s"], obs["c"]
    prior = jnp.sum(x * jnp.log(0.3) + (1.0 - x) * jnp.log(0.7), -1)
    lp = prior - 0.5 * jnp.sum(((mu - 2.0 * x) / 0.5) ** 2, -1)
    lp = lp - 0.5 * s ** 2 - jnp.abs(c - 0.3 * s)
    return lp - 0.5 * jnp.sum((jnp.asarray(_Y) - mu - s[..., None]) ** 2, -1)


def t_lj(obs):
    x, mu, s, c = obs["x"], obs["mu"], obs["s"], obs["c"]
    prior = torch.sum(x * np.log(0.3) + (1.0 - x) * np.log(0.7), -1)
    lp = prior - 0.5 * torch.sum(((mu - 2.0 * x) / 0.5) ** 2, -1)
    lp = lp - 0.5 * s ** 2 - torch.abs(c - 0.3 * s)
    return lp - 0.5 * torch.sum((torch.tensor(_Y) - mu - s[..., None]) ** 2,
                                -1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _components(lib, support):
    return [(lib.DiscreteGibbs({"x": support}), ["x"]),
            (lib.HMC(step_size=0.2, n_leapfrogs=4, adapt_step_size=True),
             ["mu"]),
            (lib.RandomWalkMetropolis(step_size=0.5, adapt_step_size=True),
             ["s"]),
            (lib.SliceSampler(width=0.5, adapt_width=True, max_shrinks=8),
             ["c"])]


def _noise(key):
    k_x, k_mu, k_s, k_c = jax.random.split(key, 4)
    (kx,) = jax.random.split(k_x, 1)
    x = {"x": np.stack([np.array(jax.random.gumbel(
        kj, (2, N_CHAINS), jnp.float64)) for kj in jax.random.split(kx, 2)])}
    key_p, key_u, _ = jax.random.split(k_mu, 3)
    (kp,) = jax.random.split(key_p, 1)
    mu = (torch.tensor(np.array(jax.random.normal(
              kp, (N_CHAINS, 2), jnp.float64))),
          torch.tensor(np.array(jax.random.uniform(
              key_u, (N_CHAINS,), jnp.float64))))
    key_prop, key_mh = jax.random.split(k_s)
    s = ({k: np.asarray(v) for k, v in j_tree_normal_like(
            key_prop, {"s": jnp.zeros(N_CHAINS)}).items()},
         np.array(jax.random.uniform(key_mh, (N_CHAINS,), jnp.float64)))
    c = _slice_noise(k_c, 1, (N_CHAINS,), 8, 8)
    return [x, mu, s, c]


def _init():
    rng = np.random.default_rng(7)
    return {"x": rng.integers(0, 2, (N_CHAINS, 2)).astype(np.float64),
            "mu": rng.standard_normal((N_CHAINS, 2)),
            "s": rng.standard_normal(N_CHAINS),
            "c": rng.standard_normal(N_CHAINS)}


def test_one_sweep_and_30_sweeps():
    j = jm.Gibbs(_components(jm, jnp.asarray([0.0, 1.0])))
    t = tm.Gibbs(_components(tm, torch.tensor([0.0, 1.0],
                                              dtype=torch.float64)))
    q0 = _init()
    key = jax.random.PRNGKey(12)
    js0 = j.init({k: jnp.asarray(v) for k, v in q0.items()}, 1)
    ts0 = t.init({k: torch.tensor(v) for k, v in q0.items()}, 1)
    jn, jinfo = j.sample(j_lj, {}, js0, key, adapt=True)
    tn, tinfo = t.sample(t_lj, {}, ts0, adapt=True, noise=_noise(key))
    for k in q0:
        _close(tn.q[k], jn.q[k])
    _close(tinfo.log_prob, jinfo.log_prob)

    n_iters = 30
    jst, jout = j.run(j_lj, {}, js0, key, n_iters, n_adapt=15)
    noise, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        noise.append(_noise(sub))
    tst, tout = t.run(t_lj, {}, ts0, None, n_iters, n_adapt=15, noise=noise)
    for n in q0:
        _close(tout["samples"][n], jout["samples"][n])
    _close(tout["log_prob"], jout["log_prob"])
    # The components' tuning state: HMC's and RWM's step sizes, the slice
    # sampler's widths.
    _close(tst.sub_states[1].step_size, jst.sub_states[1].step_size)
    _close(tst.sub_states[2].step_size, jst.sub_states[2].step_size)
    _close(tst.sub_states[3].width, jst.sub_states[3].width)
    assert tst.t == n_iters and tst.sub_states[1].t == n_iters


def test_thinning_dispatch_and_errors():
    t = tm.Gibbs(_components(tm, torch.tensor([0.0, 1.0],
                                              dtype=torch.float64)))
    st = t.init({k: torch.tensor(v) for k, v in _init().items()}, 1)
    full_st, full = t.run(t_lj, {}, st, (2, 3), 7, n_adapt=3)
    thin_st, thin = t.run(t_lj, {}, st, (2, 3), 7, n_adapt=3, thinning=2)
    for n in st.q:
        assert torch.equal(thin["samples"][n], full["samples"][n][1::2])
        assert torch.equal(thin_st.q[n], full_st.q[n])
    # A component built without adaptation is not adapted by the gate.
    rwm = tm.RandomWalkMetropolis(step_size=0.5)
    g = tm.Gibbs([(rwm, ["s"]), (tm.SliceSampler(), ["mu", "c", "x"])])
    gst = g.init({k: torch.tensor(v) for k, v in _init().items()}, 1)
    gst, _ = g.run(t_lj, {}, gst, (1, 1), 4, n_adapt=4)
    assert float(gst.sub_states[0].step_size) == 0.5
    with pytest.raises(TypeError, match="EllipticalSlice"):
        tm.Gibbs([(tm.EllipticalSlice(), ["s"])])
    with pytest.raises(ValueError, match="at least one"):
        tm.Gibbs([])
    with pytest.raises(ValueError, match="disjoint"):
        tm.Gibbs([(rwm, ["s"]), (tm.SliceSampler(), ["s"])])
    with pytest.raises(ValueError, match=">= 1 latent"):
        tm.Gibbs([(rwm, [])])
    with pytest.raises(ValueError, match="exactly cover"):
        g.init({"s": torch.zeros(3)}, 1)
    with pytest.raises(ValueError, match="collect field"):
        g.run(t_lj, {}, gst, (1, 2), 2, collect_fields=("nope",))
