"""Parity tests of the port's NUTS built-ins over several latents
(``zhusuan_tpu_torch/ops/densities.py``: ``EightSchoolsLogJoint``,
``OrderedLogisticRegressionLogJoint``, ``WeibullAFTLogJoint``), the NUTS
gate that routes them to the kernel, and the five examples they and
``extra.py`` / ``mixture.py`` unblock (``examples/robust_models/``,
``hierarchical/eight_schools.py``, ``mixture_models/gmm.py``) against the
JAX package, on the CPU in float64.

- Each built-in's value and gradient against the JAX example's
  ``transform_log_joint(log_joint, bijectors)[0]`` at 1e-12, at random
  points, ``tau`` near 0 and beyond softplus's float64 range, and with
  heavy censoring; ``log_prob``'s written-out gradient against
  ``value_and_grad``; the kernel's wrapper on CPU tensors (its plain
  version) against the plain transition on the built-in.
- 30 chained adaptive NUTS iterations on each built-in against JAX's NUTS on
  the closure, fed JAX's draws through ``noise=``
  (``tests/test_torch_nuts.py::_jax_draws``): 1e-8.
- The gate: the latent dict, dtypes, shapes, mass, observed leaves and the
  kernel's limits, with its reasons; ``"auto"`` on CPU tensors takes the
  plain path.
- The examples at a small size on the JAX examples' data: their log-joints
  at 1e-12, HMC steps fed JAX's draws at 1e-8 (``robust_regression``,
  ``gmm``, ``eight_schools.main``), ``responsibilities``, and each
  ``run`` / ``main`` end to end on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from examples.hierarchical import eight_schools as jes
from examples.mixture_models import gmm as jgmm
from examples.robust_models import ordinal_regression as jorx
from examples.robust_models import robust_regression as jrr
from examples.robust_models import survival_regression as jsr
from zhusuan_tpu.bijectors import Ordered as JOrdered
from zhusuan_tpu.bijectors import Softplus as JSoftplus
from zhusuan_tpu.bijectors import transform_log_joint as jtransform
from zhusuan_tpu.mcmc.nuts import NUTS as JNUTS
from zhusuan_tpu_torch.bijectors import Ordered, Softplus, transform_log_joint
from zhusuan_tpu_torch.examples.hierarchical import eight_schools as tes
from zhusuan_tpu_torch.examples.mixture_models import gmm as tgmm
from zhusuan_tpu_torch.examples.robust_models import (
    ordinal_regression as torx,
)
from zhusuan_tpu_torch.examples.robust_models import (
    robust_regression as trr,
)
from zhusuan_tpu_torch.examples.robust_models import (
    survival_regression as tsr,
)
from zhusuan_tpu_torch.mcmc import HMC as THMC
from zhusuan_tpu_torch.mcmc.hmc import state_from_numpy
from zhusuan_tpu_torch.mcmc.nuts import NUTS as TNUTS
from zhusuan_tpu_torch.mcmc.nuts import nuts_transition, value_and_grad
from zhusuan_tpu_torch.ops.densities import (
    EightSchoolsLogJoint,
    LatentDictDensity,
    OrderedLogisticRegressionLogJoint,
    WeibullAFTLogJoint,
)
from zhusuan_tpu_torch.ops.nuts_step import (
    DENSITIES,
    fused_nuts_transition,
    nuts_shared_bytes,
)
from tests.test_torch_nuts import _jax_draws

torch.set_num_threads(1)

TOL = 1e-12
TOL_CHAIN = 1e-8


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------- #
# The built-ins and the JAX closures they stand for
# --------------------------------------------------------------------- #
def _ordinal_data(n=40):
    x, y, _ = jorx.make_data(n, jax.random.PRNGKey(1))
    return np.asarray(x, np.float64), np.asarray(y)


def _survival_data(n=40, censor_scale=1.0):
    x, y, c, _, _ = jsr.make_data(n, jax.random.PRNGKey(4))
    c = np.asarray(c, np.float64) * censor_scale
    y = np.minimum(np.asarray(y, np.float64), c)
    return np.asarray(x, np.float64), y, c


def _case(name):
    """``(built-in, JAX unconstrained closure, JAX observed, latent dict
    of numpy arrays at 6 chains)`` for a named case."""
    rng = np.random.RandomState(hash(name) % 1000)
    c = 6
    if name.startswith("eight_schools"):
        centred = "centred" in name and "non" not in name
        lj = jes.make_centered_log_joint() if centred else jes.make_log_joint()
        ulj, _, _ = jtransform(lj, {"tau": JSoftplus()})
        dens = EightSchoolsLogJoint(jes.Y, jes.SIGMA, centered=centred)
        tau = rng.randn(c) * 2.0
        if name.endswith("small_tau"):
            tau = np.array([-3.0, -8.0, -20.0, -40.0, 0.0, 1.0])
        q = {"mu": rng.randn(c) * 5.0, "tau": tau,
             dens.theta_name: rng.randn(c, 8) * (3.0 if centred else 1.0)}
        return dens, ulj, {}, q
    if name == "ordinal":
        x, y = _ordinal_data()
        ulj, _, _ = jtransform(jorx.build_log_joint(x, y),
                               {"cuts": JOrdered()})
        dens = OrderedLogisticRegressionLogJoint(x, y, 4)
        return dens, ulj, {}, {"beta": rng.randn(c, 2),
                               "cuts": rng.randn(c, 3)}
    scale = 0.25 if name == "survival_heavy_censoring" else 1.0
    x, y, cc = _survival_data(censor_scale=scale)
    ulj, _, _ = jtransform(jsr.build_log_joint(x, y, cc), {"k": JSoftplus()})
    yt = torch.tensor(y)
    dens = WeibullAFTLogJoint(x, yt, cc)
    return dens, ulj, {"y": jnp.asarray(y)}, {"beta": rng.randn(c, 3) * 0.5,
                                              "k": rng.randn(c)}


CASES = ["eight_schools_noncentred", "eight_schools_noncentred_small_tau",
         "eight_schools_centred", "eight_schools_centred_small_tau",
         "ordinal", "survival", "survival_heavy_censoring"]


@pytest.mark.parametrize("name", CASES)
def test_builtin_value_and_grad_match_the_jax_closure(name):
    dens, ulj, jobs, q = _case(name)
    flat = np.concatenate([q[k].reshape(q[k].shape[0], -1)
                           for k in dens.names], -1)

    def f(x):
        d, s = {}, 0
        for k in dens.names:
            d[k] = x[..., s:s + dens.sizes[k]].reshape(
                x.shape[:-1] + dens.shapes[k])
            s += dens.sizes[k]
        return ulj({**d, **jobs})

    want_v = np.asarray(f(jnp.asarray(flat)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(flat)))
    got_v, got_g = dens.value_and_grad(torch.tensor(flat))
    scale = np.abs(want_v).max()
    _close(got_v / scale, want_v / scale)
    _close(got_g / np.abs(want_g).max(), want_g / np.abs(want_g).max())
    # log_prob's backward is the written-out gradient; the density on the
    # latent dict ravels it in sorted-name order.
    x = torch.tensor(flat, requires_grad=True)
    dens.log_prob(x).sum().backward()
    assert torch.equal(x.grad, got_g)
    obs = {k: torch.tensor(v) for k, v in q.items()}
    assert torch.equal(dens(obs), got_v)


def test_builtin_metadata_and_kernel_arrays():
    dens = EightSchoolsLogJoint(jes.Y, jes.SIGMA)
    assert dens.names == ("mu", "tau", "theta_tilde")
    assert dens.shapes == {"mu": (), "tau": (), "theta_tilde": (8,)}
    assert dens.dim == 10 and dens.n_rows == 8 and dens.kernel_id == 3
    assert EightSchoolsLogJoint(jes.Y, jes.SIGMA, True).kernel_id == 4
    x, y = _ordinal_data()
    o = OrderedLogisticRegressionLogJoint(x, y, 4)
    assert o.names == ("beta", "cuts") and o.dim == 5
    table, consts = o.kernel_args("cpu")
    assert table.dtype == torch.float32 and table.shape == (40, 3)
    assert table.is_contiguous()
    np.testing.assert_array_equal(consts[:2].numpy(), [2, 3])
    xs, ys, cs = _survival_data()
    w = WeibullAFTLogJoint(xs, torch.tensor(ys), cs)
    assert w.names == ("beta", "k") and w.dim == 4
    assert w.kernel_args("cpu")[0].shape == (40, 5)
    assert all(isinstance(d, LatentDictDensity) for d in (dens, o, w))
    assert all(type(d) in DENSITIES for d in (dens, o, w))
    # The kernel's limits.
    assert dens.kernel_ineligible() is None
    assert "14 schools" in EightSchoolsLogJoint(
        np.zeros(15), np.ones(15)).kernel_ineligible()
    assert "p <= 4" in OrderedLogisticRegressionLogJoint(
        np.zeros((3, 5)), [0, 1, 2], 3).kernel_ineligible()
    assert "p <= 8" in WeibullAFTLogJoint(
        np.zeros((3, 9)), np.ones(3), np.ones(3)).kernel_ineligible()
    # A carried density keeps one more shared row a chain.
    assert nuts_shared_bytes(10, 8, True, dens.n_rows) == (
        nuts_shared_bytes(10, 8, True) + 4 * 3 * 16)


@pytest.mark.parametrize("bad,match", [
    (lambda: EightSchoolsLogJoint(np.zeros((2, 3)), np.ones(3)), "1-D"),
    (lambda: OrderedLogisticRegressionLogJoint(np.zeros(4), [0], 3),
     r"\[n, p\]"),
    (lambda: OrderedLogisticRegressionLogJoint(np.zeros((2, 1)), [0, 3], 3),
     "lie in"),
    (lambda: OrderedLogisticRegressionLogJoint(np.zeros((2, 1)), [0.5, 1.0],
                                               3), "category"),
    (lambda: OrderedLogisticRegressionLogJoint(np.zeros((2, 1)), [0, 0], 1),
     ">= 2"),
    (lambda: WeibullAFTLogJoint(np.zeros((2, 1)), np.ones(3), np.ones(3)),
     r"\[n, p\]"),
])
def test_builtin_checks(bad, match):
    with pytest.raises(ValueError, match=match):
        bad()


def test_builtin_refuses_data_it_does_not_hold():
    x, y, c = _survival_data()
    yt = torch.tensor(y)
    dens = WeibullAFTLogJoint(x, yt, c)
    q = {"beta": torch.zeros(2, 3, dtype=torch.float64),
         "k": torch.zeros(2, dtype=torch.float64)}
    assert dens.holds("y", yt) and not dens.holds("y", yt.clone())
    torch.testing.assert_close(dens({**q, "y": yt}), dens(q))
    with pytest.raises(ValueError, match="holds its data"):
        dens({**q, "y": yt.clone()})
    with pytest.raises(ValueError, match="holds its data"):
        dens({**q, "z": yt})


# --------------------------------------------------------------------- #
# NUTS on the built-ins: the gate, the wrapper's plain version, and 30
# chained iterations against the JAX package on its draws
# --------------------------------------------------------------------- #
def _f32(q):
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in q.items()}


def test_nuts_gate_takes_the_builtins_and_says_why_not():
    nuts = TNUTS(max_tree_depth=8)
    ok = nuts._fused_ineligible
    for name in ("eight_schools_noncentred", "ordinal", "survival"):
        dens, _, _, q = _case(name)
        tq = _f32(q)
        m = {k: torch.ones((1,) + dens.shapes[k]) for k in dens.names}
        held = {k: v for k, v in dens.held.items()}
        assert ok(dens, held, tq, m, 1) is None, name
        first = dens.names[0]
        assert "latents" in ok(dens, {}, {first: tq[first]}, m, 1)
        assert "latents" in ok(dens, {}, {**tq, "w": tq[first]}, m, 1)
        assert "float32" in ok(dens, held, {**tq, first: tq[first].double()},
                               m, 1)
        assert "n_chains" in ok(dens, held, {**tq, first: tq[first][:3]},
                                m, 1)
        assert "mass" in ok(dens, held, tq, {**m, first: m[first].double()},
                            1)
        assert "chain axis" in ok(dens, held, tq, m, 2)
        assert "observed" in ok(dens, {"y": torch.zeros(3)}, tq, m, 1)
        deep = TNUTS(max_tree_depth=13)._fused_ineligible
        assert "max_tree_depth" in deep(dens, held, tq, m, 1)
    dens = OrderedLogisticRegressionLogJoint(np.zeros((3, 5)), [0, 1, 2], 3)
    tq = {"beta": torch.zeros(4, 5), "cuts": torch.zeros(4, 2)}
    m = {"beta": torch.ones(1, 5), "cuts": torch.ones(1, 2)}
    assert "p <= 4" in ok(dens, {}, tq, m, 1)
    # HMC keeps the one-latent gate.
    dens, _, _, q = _case("ordinal")
    tq = _f32(q)
    m = {k: torch.ones((1,) + dens.shapes[k]) for k in dens.names}
    assert "single tensor" in THMC()._fused_ineligible(dens, {}, tq, m, 1)


def test_fused_true_on_cpu_tensors_takes_the_plain_path():
    dens, _, _, q = _case("survival")
    nuts = TNUTS(step_size=0.1, max_tree_depth=4,
                 experimental_fused_step=True)
    st = nuts.init(_f32(q), n_chain_dims=1)
    before = fused_nuts_transition.launches
    st, info = nuts.sample(dens, dict(dens.held), st, (1, 2))
    assert fused_nuts_transition.launches == before
    assert st.t == 1 and info.depth.shape == (6,)
    assert set(st.q) == {"beta", "k"} and st.q["k"].shape == (6,)


@pytest.mark.parametrize("name", ["eight_schools_centred", "ordinal",
                                  "survival"])
def test_kernel_wrapper_on_cpu_is_the_plain_transition(name):
    dens, _, _, q = _case(name)
    flat = dens.ravel({k: torch.tensor(v) for k, v in q.items()})
    c, d = flat.shape
    depth = 5
    g = torch.Generator().manual_seed(3)
    noise = (torch.randn(c, d, generator=g, dtype=torch.float64),
             torch.rand(c, depth, generator=g, dtype=torch.float64),
             torch.rand(c, 2 ** depth - 1, generator=g, dtype=torch.float64),
             torch.rand(c, depth, generator=g, dtype=torch.float64))
    inv_mass = 0.5 + torch.rand(1, d, generator=g, dtype=torch.float64)
    got = fused_nuts_transition(dens, flat, inv_mass, 0.1, depth, 1000.0,
                                (1, 2), 0, noise=noise)
    want = nuts_transition(value_and_grad(lambda x: dens.log_prob(x)), flat,
                           inv_mass[0], 0.1, depth, 1000.0, noise)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _jax_nuts_vs_port(dens, ulj, jobs, q, depth, step, n_iter=30,
                      seed=300):
    """30 chained adaptive iterations of JAX's NUTS on the closure; at
    each, the port's NUTS on the built-in, from JAX's state and on JAX's
    draws, must give JAX's next state. (Run on its own instead, the port's
    chain drifts from JAX's by 1e-7 to 1e-6 relative over 30 iterations:
    the written-out gradient and the float64 row sums differ from JAX's
    autodiff at the ulp, and a trajectory of hundreds of leapfrogs
    amplifies that.)"""
    kw = dict(step_size=step, max_tree_depth=depth, adapt_step_size=True)
    jnuts, tnuts = JNUTS(**kw), TNUTS(**kw)
    jst = jnuts.init({k: jnp.asarray(v) for k, v in q.items()},
                     n_chain_dims=1)
    step_fn = jax.jit(lambda s, k: jnuts.sample(ulj, jobs, s, k))
    c = next(iter(q.values())).shape[0]
    tobs = dict(dens.held)
    depths = []
    for i in range(n_iter):
        key = jax.random.PRNGKey(seed + i)
        tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
        jst, info = step_fn(jst, key)
        tst, tinfo = tnuts.sample(dens, tobs, tst,
                                  noise=_jax_draws(key, c, dens.dim, depth))
        assert tst.t == i + 1
        _close(tinfo.log_prob, info.log_prob, TOL_CHAIN)
        _close(tinfo.acceptance_rate, info.acceptance_rate, TOL_CHAIN)
        assert torch.equal(tinfo.depth, _t(info.depth))
        assert torch.equal(tinfo.divergent, _t(info.divergent))
        for k in q:
            _close(tst.q[k], jst.q[k], TOL_CHAIN)
        _close(tst.step_size, jst.step_size, TOL_CHAIN)
        depths.append(np.asarray(info.depth).mean())
    return depths


@pytest.mark.parametrize("name,depth,step", [
    ("eight_schools_noncentred", 8, 0.2),
    ("eight_schools_centred", 8, 0.2),
    ("ordinal", 6, 0.2),
    ("survival", 6, 0.1),
])
def test_thirty_chained_nuts_iterations_match_jax(name, depth, step):
    dens, ulj, jobs, q = _case(name)
    q = {k: v * 0.3 for k, v in q.items()}
    depths = _jax_nuts_vs_port(dens, ulj, jobs, q, depth, step)
    assert max(depths) > 1


# --------------------------------------------------------------------- #
# The examples
# --------------------------------------------------------------------- #
def _hmc_noise(key, q):
    """JAX ``HMC.sample(key)``'s draws for a latent dict: ``split(key, 3)
    -> key_p, key_u, key_j``, the momentum normals from ``split(key_p,
    len(q))`` in sorted-name order."""
    key_p, key_u, _ = jax.random.split(key, 3)
    names = sorted(q)
    keys = jax.random.split(key_p, len(names))
    eps = {n: _t(jax.random.normal(k, q[n].shape, jnp.float64))
           for n, k in zip(names, keys)}
    c = next(iter(q.values())).shape[0]
    return eps, _t(jax.random.uniform(key_u, (c,), jnp.float64))


def _hmc_steps(jhmc, thmc, jlj, tlj, q, n_iter, adapt=True, seed=50):
    jst = jhmc.init({k: jnp.asarray(v) for k, v in q.items()},
                    n_chain_dims=1)
    tst = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    step_fn = jax.jit(lambda s, k: jhmc.sample(jlj, {}, s, k,
                                               adapt_step_size=adapt,
                                               adapt_mass=adapt))
    for i in range(n_iter):
        key = jax.random.PRNGKey(seed + i)
        jst, _ = step_fn(jst, key)
        tst, _ = thmc.sample(tlj, {}, tst, adapt_step_size=adapt,
                             adapt_mass=adapt,
                             noise=_hmc_noise(key, jst.q))
    _close(tst.q, {k: np.asarray(v) for k, v in jst.q.items()}, TOL_CHAIN)
    _close(tst.step_size, jst.step_size, TOL_CHAIN)


def _f64(v):
    return jnp.asarray(v, jnp.float64)


def test_robust_regression_matches_jax():
    jx, jy = jrr.make_data()
    tx, ty = trr.make_data()
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    jlj = jrr.make_log_joint(_f64(jx), _f64(jy))
    tlj = trr.make_log_joint(tx, ty, dtype=torch.float64)
    rng = np.random.RandomState(0)
    q = {"w": rng.randn(5), "sigma": 0.2 + rng.rand(5)}
    want = jlj({k: _f64(v) for k, v in q.items()})
    _close(tlj({k: _t(v) for k, v in q.items()}), want)
    julj, jto_u, _ = jtransform(jlj, {"sigma": JSoftplus()})
    tulj, tto_u, _ = transform_log_joint(tlj, {"sigma": Softplus()})
    u = {k: np.asarray(v) for k, v in jto_u(
        {k: _f64(v) for k, v in q.items()}).items()}
    _hmc_steps(zs.HMC(step_size=0.05, n_leapfrogs=10,
                      adapt_step_size=True), trr.make_sampler(), julj, tulj,
               u, 10)


def test_robust_regression_main_runs():
    slope, ols = trr.main(8, 40, 20, device="cpu", verbose=False)
    assert np.isfinite(slope) and abs(ols - 1.7448072056298447) < 1e-12


def test_gmm_matches_jax():
    jx, jc = jgmm.make_data(60)
    tx, tc = tgmm.make_data(60)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tc, jc)
    jlj = jgmm.make_log_joint(_f64(jx))
    tlj = tgmm.make_log_joint(tx, dtype=torch.float64)
    init = tgmm.init_latent(4, dtype=torch.float64)
    np.testing.assert_array_equal(
        init["mu"].numpy(), np.random.default_rng(1).normal(0, 3, (4, 3)))
    rng = np.random.RandomState(1)
    q = {"logits": rng.randn(4, 3), "mu": rng.randn(4, 3) * 3,
         "log_sd": rng.randn(4, 3) * 0.3}
    _close(tlj({k: _t(v) for k, v in q.items()}),
           jlj({k: _f64(v) for k, v in q.items()}))
    r_args = [q["logits"][0], q["mu"][0], q["log_sd"][0]]
    _close(tgmm.responsibilities(_t(tx), *[_t(a) for a in r_args]),
           jgmm.responsibilities(_f64(jx), *[_f64(a) for a in r_args]))
    _hmc_steps(zs.HMC(step_size=0.05, n_leapfrogs=20,
                      adapt_step_size=True), tgmm.make_sampler(), jlj, tlj,
               q, 5, seed=80)


def test_gmm_main_runs():
    (w, mu, sd), acc, stats = tgmm.main(4, 20, 80, n_data=60,
                                        verbose=False, device="cpu")
    assert w.shape == mu.shape == sd.shape == (3,)
    assert abs(w.sum() - 1.0) < 1e-6 and 0.0 <= acc <= 1.0
    assert tuple(stats["mu"]["mean"].shape) == (3,)


@pytest.mark.parametrize("centred", [False, True])
def test_eight_schools_log_joints_match_jax(centred):
    jlj = jes.make_centered_log_joint() if centred else jes.make_log_joint()
    tlj = (tes.make_centered_log_joint if centred
           else tes.make_log_joint)(dtype=torch.float64)
    rng = np.random.RandomState(2)
    q = {"mu": rng.randn(5) * 5, "tau": 0.1 + rng.rand(5) * 5,
         ("theta" if centred else "theta_tilde"): rng.randn(5, 8)}
    _close(tlj({k: _t(v) for k, v in q.items()}),
           jlj({k: _f64(v) for k, v in q.items()}))


def test_eight_schools_main_steps_match_jax():
    """The non-centred HMC of ``main`` (adapted step and mass) on JAX's
    draws."""
    julj, jto_u, _ = jtransform(jes.make_log_joint(), {"tau": JSoftplus()})
    tulj, _, _ = transform_log_joint(tes.make_log_joint(dtype=torch.float64),
                                     {"tau": Softplus()})
    q = {k: np.asarray(v, np.float64) for k, v in jto_u(
        {k: _f64(v.numpy()) for k, v in tes.funnel_init(
            False, 4, dtype=torch.float64).items()}).items()}
    _hmc_steps(zs.HMC(step_size=0.1, n_leapfrogs=10, adapt_step_size=True,
                      adapt_mass=True),
               THMC(step_size=0.1, n_leapfrogs=10, adapt_step_size=True,
                    adapt_mass=True), julj, tulj, q, 12, seed=90)


def test_eight_schools_funnel_density_is_the_closure():
    """``funnel_density``'s built-in equals ``transform_log_joint`` of the
    port's own closure; its maps are the closure's."""
    for centred in (False, True):
        dens, to_u, to_c = tes.funnel_density(centred)
        lj = (tes.make_centered_log_joint if centred
              else tes.make_log_joint)(dtype=torch.float64)
        ulj, _, _ = transform_log_joint(lj, {"tau": Softplus()})
        init = tes.funnel_init(centred, 3, dtype=torch.float64)
        u = to_u(init)
        u = {k: v + 0.3 * torch.randn(v.shape, dtype=torch.float64,
                                      generator=torch.Generator()
                                      .manual_seed(1)) for k, v in u.items()}
        _close(dens(u), ulj(u).numpy(), 1e-12)
        _close(to_c(u)["tau"], torch.logaddexp(u["tau"],
                                               torch.zeros(3,
                                                           dtype=torch
                                                           .float64)))


def test_eight_schools_main_and_funnel_run():
    stats, theta = tes.main(4, 30, 15, verbose=False, device="cpu")
    assert theta.shape == (15, 4, 8) and np.isfinite(theta).all()
    assert set(stats) == {"mu", "tau", "theta"}
    c_rate, nc_rate, small = tes.funnel_diagnosis(4, 16, 8, verbose=False,
                                                  device="cpu")
    assert 0.0 <= c_rate <= 1.0 and 0.0 <= nc_rate <= 1.0


def test_ordinal_closure_and_run_match_jax():
    x, y = _ordinal_data()
    ulj, to_u, to_c = jtransform(jorx.build_log_joint(x, y),
                                 {"cuts": JOrdered()})
    dens, tto_u, tto_c = torx.build_density(torch.tensor(x), torch.tensor(y))
    tulj, _, _ = transform_log_joint(
        torx.build_log_joint(x, y, dtype=torch.float64),
        {"cuts": Ordered()})
    rng = np.random.RandomState(4)
    q = {"beta": rng.randn(3, 2), "cuts": rng.randn(3, 3)}
    want = ulj({k: _f64(v) for k, v in q.items()})
    _close(tulj({k: _t(v) for k, v in q.items()}), want)
    _close(dens({k: _t(v) for k, v in q.items()}), want)
    init = torx.init_latent(3, dtype=torch.float64)
    _close(tto_u(init), {k: np.asarray(v) for k, v in to_u(
        {k: _f64(v.numpy()) for k, v in init.items()}).items()})
    res = torx.run(data=(torch.tensor(x), torch.tensor(y)), n_chains=4,
                   n_iters=30, burnin=10, device="cpu")
    assert res["cuts_draws"].shape == (80, 3)
    assert (np.diff(res["cuts_draws"], axis=-1) > 0).all()
    x2, y2, synthetic = torx.make_data(50, torch.Generator().manual_seed(0))
    assert x2.shape == (50, 2) and set(y2.tolist()) <= {0, 1, 2, 3}
    assert synthetic


def test_survival_closure_and_run_match_jax():
    x, y, c = _survival_data()
    ulj, to_u, _ = jtransform(jsr.build_log_joint(x, y, c),
                              {"k": JSoftplus()})
    dens, tto_u, _ = tsr.build_density(x, torch.tensor(y), c)
    tulj, _, _ = transform_log_joint(
        tsr.build_log_joint(x, y, c, dtype=torch.float64),
        {"k": Softplus()})
    rng = np.random.RandomState(5)
    q = {"beta": rng.randn(3, 3) * 0.5, "k": rng.randn(3)}
    want = ulj({**{k: _f64(v) for k, v in q.items()}, "y": _f64(y)})
    _close(tulj({**{k: _t(v) for k, v in q.items()}, "y": _t(y)}), want)
    _close(dens({k: _t(v) for k, v in q.items()}), want)
    res = tsr.run(data=(x, y, c), n_chains=4, n_iters=30, burnin=10,
                  device="cpu")
    assert np.isfinite(res["k_mean"]) and res["beta_mean"].shape == (3,)
    assert abs(res["frac_censored"] - np.mean(y >= c)) < 1e-12
    x2, y2, c2, frac, synthetic = tsr.make_data(
        200, torch.Generator().manual_seed(0))
    assert x2.shape == (200, 3) and 0.2 < frac < 0.6 and synthetic
    assert bool((y2 <= c2).all())
