"""Parity tests of zhusuan_tpu_torch.mcmc.precondition against the JAX
package, and of the slice as a whole: ``bench.py``'s ``measure_mixing``
arms (fixed-L HMC, ChEES, dense-preconditioned HMC) on the equicorrelated
target at 64 chains x 8 dims, chained on JAX's own draws. CPU, float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu.mcmc import fit_dense_preconditioner as j_fit
from zhusuan_tpu.mcmc import whiten_log_joint as j_whiten
from zhusuan_tpu.mcmc.chees import ChEESHMC as JChEES
from zhusuan_tpu.mcmc.hmc import HMC as JHMC
from zhusuan_tpu_torch.mcmc import base as tbase
from zhusuan_tpu_torch.mcmc import chees as tchees
from zhusuan_tpu_torch.mcmc import fit_dense_preconditioner as t_fit
from zhusuan_tpu_torch.mcmc import whiten_log_joint as t_whiten
from zhusuan_tpu_torch.mcmc.chees import ChEESHMC as TChEES
from zhusuan_tpu_torch.mcmc.hmc import HMC as THMC
from zhusuan_tpu_torch.mcmc.hmc import state_from_numpy, state_to_numpy
from zhusuan_tpu_torch.ops.densities import (
    EquicorrelatedGaussianLogJoint,
    WhitenedLogJoint,
)

torch.set_num_threads(1)

C, D, RHO = 64, 8, 0.95
TOL = 1e-12  # float64 on both sides; only the order of sums differs


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _equi_closure(d=D, rho=RHO):
    """bench.py:307-313."""
    a_c = float(1.0 / (1.0 - rho))
    b_c = float(rho / ((1.0 - rho) * (1.0 + (d - 1) * rho)))

    def log_joint(obs):
        z = obs["z"]
        return -0.5 * (a_c * jnp.sum(z * z, -1) - b_c * jnp.sum(z, -1) ** 2)

    return log_joint


def _correlated_draws(seed, shape):
    rs = np.random.RandomState(seed)
    cov = RHO * np.ones((D, D)) + (1 - RHO) * np.eye(D)
    return rs.randn(*shape, D) @ np.linalg.cholesky(cov).T


# --------------------------------------------------------------------- #
# (a) fit_dense_preconditioner and whiten_log_joint
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,shrinkage", [((30, 16), 5.0),
                                             ((200,), 0.0), ((1,), 5.0)])
def test_fit_dense_preconditioner_matches_jax(shape, shrinkage):
    x = _correlated_draws(0, shape)
    want = np.asarray(j_fit(jnp.asarray(x), shrinkage=shrinkage))
    got = t_fit(_t(x), shrinkage=shrinkage)
    assert got.dtype == torch.float64 and got.shape == (D, D)
    _close(got, want, TOL)
    assert torch.equal(got, torch.tril(got))


def test_whiten_log_joint_matches_jax():
    chol = np.asarray(j_fit(jnp.asarray(_correlated_draws(1, (40, 8)))))
    jlj = _equi_closure()
    tlj = EquicorrelatedGaussianLogJoint("z", D, RHO)
    jw, j_to, j_from = j_whiten(jlj, "z", jnp.asarray(chol))
    tw, t_to, t_from = t_whiten(tlj, "z", _t(chol))
    y = np.random.RandomState(2).randn(3, C, D)
    q = _correlated_draws(3, (3, C))
    _close(t_from(_t(y)), j_from(jnp.asarray(y)), TOL)
    _close(t_to(_t(q)), j_to(jnp.asarray(q)), TOL)
    # to_white inverts from_white.
    _close(t_to(t_from(_t(y))), y, TOL)
    yc = _t(y[0])
    _close(tw({"z": yc}), jw({"z": jnp.asarray(y[0])}), TOL)
    want_g = jax.grad(lambda v: jnp.sum(jw({"z": v})))(jnp.asarray(y[0]))
    got_g = tbase.make_grad_fn(tbase.make_log_joint_fn(tw, {}))({"z": yc})
    _close(got_g["z"], want_g, TOL)
    # Whitening a built-in gives the built-in the HMC kernel takes; any
    # other log-joint stays a plain callable.
    assert isinstance(tw, WhitenedLogJoint)
    closure_w, _, _ = t_whiten(lambda obs: tlj(obs), "z", _t(chol))
    assert callable(closure_w) and not isinstance(closure_w,
                                                  WhitenedLogJoint)
    _close(closure_w({"z": yc}), jw({"z": jnp.asarray(y[0])}), TOL)


# --------------------------------------------------------------------- #
# (b) the slice as a whole: measure_mixing's three arms, chained on JAX's
# draws (bench.py:370-433, cut to 64 x 8 and a few iterations each)
# --------------------------------------------------------------------- #
def _hmc_chain(jhmc, thmc, jlj, tlj, jst, tst, n_iter, n_adapt, seed):
    """Chain ``n_iter`` HMC.sample iterations in both packages, the port on
    JAX's momentum and uniforms; returns the final states and the port's
    samples of the frozen iterations."""
    steps = {a: jax.jit(lambda s, k, a=a: jhmc.sample(
        jlj, {}, s, k, adapt_step_size=a,
        adapt_mass=a if jhmc.adapt_mass is not None else None))
        for a in (True, False)}
    samples = []
    for i in range(n_iter):
        adapt = i < n_adapt
        key = jax.random.PRNGKey(seed + i)
        jnew, info = steps[adapt](jst, key)
        # mcmc/hmc.py:557,688: p = normal(key_p) * sqrt(mass), u from key_u.
        eps = np.asarray(info.init_momentum["z"]) / np.sqrt(
            np.asarray(jnew.mass["z"]))
        _, key_u, _ = jax.random.split(key, 3)
        u = np.asarray(jax.random.uniform(key_u, (C,), jnp.float64))
        tst, tinfo = thmc.sample(
            tlj, {}, tst, adapt_step_size=adapt,
            adapt_mass=adapt if thmc.adapt_mass is not None else None,
            noise=(_t(eps), _t(u)))
        _close(tinfo.acceptance_rate, info.acceptance_rate, 1e-8)
        jst = jnew
        if not adapt:
            samples.append(tinfo.samples["z"])
    for name in ("q", "step_size", "mass", "log_epsilon_bar"):
        _close(getattr(state_to_numpy(tst), name),
               jax.tree_util.tree_map(np.asarray, getattr(jst, name)), 1e-8)
    return jst, tst, torch.stack(samples)


def test_measure_mixing_arms_match_jax():
    jlj = _equi_closure()
    tlj = EquicorrelatedGaussianLogJoint("z", D, RHO)
    q0 = np.zeros((C, D))

    # (a) fixed-L HMC with step-size and mass adaptation (bench.py:371-383;
    # mass_collect_iters cut from 50 to 5 so the adapted mass is used).
    kw = dict(step_size=0.1, n_leapfrogs=5, adapt_step_size=True,
              adapt_mass=True, mass_collect_iters=5)
    jhmc, thmc = JHMC(**kw), THMC(**kw)
    jst = jhmc.init({"z": jnp.asarray(q0)}, log_joint=jlj)
    tst = thmc.init({"z": _t(q0)}, log_joint=tlj)
    jst, tst, pilot = _hmc_chain(jhmc, thmc, jlj, tlj, jst, tst, 16, 8, 300)
    assert not np.allclose(state_to_numpy(tst).mass["z"], 1.0)

    # (b) ChEES (bench.py:386-394).
    jch = JChEES(step_size=0.05, trajectory_length=1.0)
    tch = TChEES(step_size=0.05, trajectory_length=1.0)
    jcs = jch.init({"z": jnp.asarray(q0)})
    tcs = tch.init({"z": _t(q0)})
    csteps = {a: jax.jit(lambda s, k, a=a: jch.sample(jlj, {}, s, k, adapt=a))
              for a in (True, False)}
    for i in range(12):
        key = jax.random.PRNGKey(400 + i)
        jcs, jinfo = csteps[i < 8](jcs, key)
        key_p, key_u = jax.random.split(key)
        (kp,) = jax.random.split(key_p, 1)
        p = np.asarray(jax.random.normal(kp, (C, D), jnp.float64))
        u = np.asarray(jax.random.uniform(key_u, (C,), jnp.float64))
        tcs, tinfo = tch.sample(tlj, {}, tcs, adapt=i < 8,
                                noise=(_t(p), _t(u)))
        assert int(tinfo.n_leapfrogs) == int(jinfo.n_leapfrogs)
        _close(tinfo.acceptance_rate, jinfo.acceptance_rate, 1e-8)
    final = tchees.state_to_numpy(tcs)
    for name in ("q", "step_size", "log_traj", "adam_m", "adam_v"):
        _close(getattr(final, name),
               jax.tree_util.tree_map(np.asarray, getattr(jcs, name)), 1e-8)

    # (c) dense-preconditioned HMC: pilot -> fit -> whiten -> HMC
    # (bench.py:404-421) on the fixed-L arm's sampling draws.
    chol_j = j_fit(jnp.asarray(pilot.numpy()[::4]).reshape(-1, D))
    chol_t = t_fit(pilot[::4].reshape(-1, D))
    _close(chol_t, chol_j, 1e-8)
    jw, j_to, j_from = j_whiten(jlj, "z", chol_j)
    tw, t_to, t_from = t_whiten(tlj, "z", chol_t)
    kw = dict(step_size=0.5, n_leapfrogs=5, adapt_step_size=True)
    jp, tp = JHMC(**kw), THMC(**kw)
    jps = jp.init({"z": j_to(jst.q["z"])}, log_joint=jw)
    tps = tp.init({"z": t_to(tst.q["z"])}, log_joint=tw)
    _close(tps.q["z"], jps.q["z"], 1e-8)
    jps, tps, white = _hmc_chain(jp, tp, jw, tw, jps, tps, 10, 6, 500)
    # The draws map back to the target's coordinates.
    back = t_from(white)
    _close(back, j_from(jnp.asarray(white.numpy())), 1e-8)
    assert torch.isfinite(back).all()


def test_state_numpy_round_trip_keeps_host_t():
    st = TChEES(step_size=0.2).init({"z": torch.zeros(4, 3,
                                                      dtype=torch.float64)})
    back = tchees.state_from_numpy(tchees.state_to_numpy(st._replace(t=7)))
    assert back.t == 7
    for name in tchees.ChEESState._fields[2:]:
        assert torch.equal(getattr(back, name), getattr(st, name))
