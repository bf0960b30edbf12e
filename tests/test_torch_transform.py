"""Parity of the port's normalizing flows (``zhusuan_tpu_torch/transform.py``,
``distributions/flow.py``) with the JAX package's, in float64 on the CPU:
the JAX ``init_*`` parameters (coupling output layers given random values,
since they start at zero) go through both packages at 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu import transform as jt
from zhusuan_tpu.distributions import FlowDistribution as JFlow
from zhusuan_tpu.distributions import Normal as JNormal
from zhusuan_tpu_torch import transform as tt
from zhusuan_tpu_torch.distributions import FlowDistribution, Normal
from zhusuan_tpu_torch.distributions import MultivariateNormalCholesky

torch.set_num_threads(1)

TOL = 1e-12
KEY = jax.random.PRNGKey(3)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _to_torch(params):
    return tt.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu", requires_grad=False)


def _coupling_params(n_flows, d, hidden=8, seed=0):
    """JAX's init with every layer given random values (its output layer
    starts at zero: the identity)."""
    params = jax.tree.map(np.asarray, jt.init_affine_coupling(
        KEY, n_flows, d, hidden=hidden, dtype=jnp.float64))
    rng = np.random.default_rng(seed)
    for p in params:
        for k in ("b1", "w2", "b2"):
            p[k] = 0.5 * rng.standard_normal(p[k].shape)
    return params


def _data(shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape[:-1])


@pytest.mark.parametrize("shape", [(5, 4), (2, 3, 4)])
def test_planar_flow(shape):
    params = jt.init_planar_flow(KEY, 3, shape[-1], dtype=jnp.float64)
    # Wider weights than the 0.005 init, so the flow bends.
    params = [{k: 20.0 * np.asarray(v) if k != "b" else np.asarray(0.3)
               for k, v in p.items()} for p in params]
    z, lp = _data(shape)
    want = jt.planar_normalizing_flow(z, lp, params)
    got = tt.planar_normalizing_flow(_t(z), _t(lp), _to_torch(params))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("update", ["normal", "gru"])
def test_iaf_linear_ar(update):
    params = jax.tree.map(
        lambda a: 50.0 * np.asarray(a),
        jt.init_linear_ar(KEY, 3, 4, dtype=jnp.float64))
    z, lp = _data((6, 4))
    want = jt.inv_autoregressive_flow(z, None, lp, jt.linear_ar, params,
                                      update=update)
    got = tt.inv_autoregressive_flow(_t(z), None, _t(lp), tt.linear_ar,
                                     _to_torch(params), update=update)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("inverse", [False, True])
def test_affine_coupling(d, inverse):
    params = _coupling_params(4, d)
    z, lp = _data((7, d))
    want = jt.affine_coupling_flow(z, lp, params, inverse=inverse)
    got = tt.affine_coupling_flow(_t(z), _t(lp), _to_torch(params),
                                  inverse=inverse)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_coupling_gradient_and_pair():
    params = _coupling_params(3, 3)
    z, lp = _data((6, 3))

    def jloss(p):
        x, lq = jt.affine_coupling_flow(z, lp, p)
        return jnp.sum(jnp.sin(x)) + jnp.sum(lq)

    want = jax.grad(jloss)(params)
    tparams = tt.params_from_numpy(params, device="cpu")
    fwd, _ = tt.coupling_flow_pair(tparams)
    x, lq = fwd(_t(z), _t(lp))
    (torch.sum(torch.sin(x)) + torch.sum(lq)).backward()
    for gp, wp in zip(tparams, want):
        for k in wp:
            _close(gp[k].grad, wp[k])


def test_coupling_inverse_round_trip():
    params = _to_torch(_coupling_params(6, 5))
    fwd, inv = tt.coupling_flow_pair(params)
    z, lp = _data((9, 5))
    x, lq = fwd(_t(z), _t(lp))
    z_back, lp_back = inv(x, torch.zeros(9, dtype=torch.float64))
    # Six flows with scales up to e^2 each amplify the rounding: 1e-10.
    _close(z_back, z, 1e-10)
    # The inverse's log-det undoes the forward's.
    _close(lp_back, _np(lq - _t(lp)), 1e-10)


def test_init_shapes_and_params_round_trip():
    g = torch.Generator().manual_seed(0)
    planar = tt.init_planar_flow(g, 2, 3, dtype=torch.float64)
    assert [tuple(p["u"].shape) for p in planar] == [(3,), (3,)]
    assert all(float(p["b"]) == 0.0 for p in planar)
    ar = tt.init_linear_ar(g, 2, 3)
    assert tuple(ar[1]["s_w"].shape) == (3, 3)
    coup = tt.init_affine_coupling(g, 3, 5, hidden=7)
    jcoup = jt.init_affine_coupling(KEY, 3, 5, hidden=7)
    for p, q in zip(coup, jcoup):
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: tuple(v.shape) for k, v in q.items()}
        assert float(p["w2"].abs().max()) == 0.0
    back = tt.params_from_numpy(tt.params_to_numpy(coup), device="cpu")
    for p, q in zip(back, coup):
        for k in p:
            assert torch.equal(p[k].detach(), q[k])
            assert p[k].requires_grad


def test_flow_errors():
    z = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="rank >= 2"):
        tt.planar_normalizing_flow(z, torch.zeros(()), [])
    with pytest.raises(ValueError, match="rank \\(N-1\\)"):
        tt.affine_coupling_flow(torch.zeros(2, 4), torch.zeros(()), [])
    with pytest.raises(ValueError, match="'normal' or 'gru'"):
        tt.inv_autoregressive_flow(torch.zeros(2, 4), None, torch.zeros(2),
                                   tt.linear_ar, [], update="lstm")


# --------------------------------------------------------------------- #
# FlowDistribution
# --------------------------------------------------------------------- #
def _bases(d):
    jb = JNormal(jnp.zeros(d, jnp.float64), std=jnp.ones(d, jnp.float64),
                 group_ndims=1)
    tb = Normal(torch.zeros(d, dtype=torch.float64),
                std=torch.ones(d, dtype=torch.float64), group_ndims=1)
    return jb, tb


def test_flow_distribution_sample_and_log_prob():
    d, n = 3, 6
    params = _coupling_params(4, d)
    jb, tb = _bases(d)
    jdist = JFlow.coupling(jb, params)
    tdist = FlowDistribution.coupling(tb, _to_torch(params))
    assert tdist.batch_shape == () and tdist.value_shape == (d,)
    key = jax.random.PRNGKey(11)
    want = jdist.sample(key, n)
    eps = jax.random.normal(key, (n, d), jnp.float64)
    got = tdist.sample(None, n, eps=np.asarray(eps))
    _close(got, want)
    _close(tdist.log_prob(_t(want)), jdist.log_prob(want))
    # one d-vector (rank 1, no batch axes)
    _close(tdist.log_prob(_t(want[0])), jdist.log_prob(want[0]))
    assert tdist.base is tb


def test_flow_distribution_batched_base():
    d = 2
    loc = np.random.default_rng(4).standard_normal((3, d))
    params = _coupling_params(2, d)
    jb = JNormal(jnp.asarray(loc), std=jnp.float64(1.5), group_ndims=1)
    tb = Normal(_t(loc), std=torch.tensor(1.5, dtype=torch.float64),
                group_ndims=1)
    jdist = JFlow.coupling(jb, params)
    tdist = FlowDistribution.coupling(tb, _to_torch(params))
    x = np.random.default_rng(5).standard_normal((4, 3, d))
    _close(tdist.log_prob(_t(x)), jdist.log_prob(x))
    # a rank-1 value broadcasts against the batch axis
    _close(tdist.log_prob(_t(x[0, 0])), jdist.log_prob(x[0, 0]))


def test_flow_distribution_mvn_base_and_errors():
    d = 3
    params = _to_torch(_coupling_params(2, d))
    mvn = MultivariateNormalCholesky(torch.zeros(d, dtype=torch.float64),
                                     torch.eye(d, dtype=torch.float64))
    FlowDistribution.coupling(mvn, params)  # reduces the last axis
    _, tb = _bases(d)
    with pytest.raises(TypeError, match="should be a Distribution"):
        FlowDistribution(object(), lambda z, lp: (z, lp))
    ungrouped = Normal(torch.zeros(d, dtype=torch.float64), std=1.0)
    with pytest.raises(ValueError, match="reduce exactly the last"):
        FlowDistribution.coupling(ungrouped, params)
    from zhusuan_tpu_torch.distributions import Bernoulli

    with pytest.raises(ValueError, match="continuous base"):
        FlowDistribution(Bernoulli(torch.zeros(d)), lambda z, lp: (z, lp))
    fwd_only = FlowDistribution(
        tb, lambda z, lp: tt.planar_normalizing_flow(z, lp, []))
    with pytest.raises(NotImplementedError, match="sample-only"):
        fwd_only.log_prob(torch.zeros(d, dtype=torch.float64))
