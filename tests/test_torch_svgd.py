"""Parity of the port's SVGD (``zhusuan_tpu_torch/variational/svgd.py``)
with ``zhusuan_tpu/variational/svgd.py`` on the CPU: the kernel terms at
1e-12, the bisection median equal to JAX's value (both of the port's
stopping tests), the optax-exact adagrad against ``optax.adagrad`` over 30
steps, and 30 SVGD updates in float64 at 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zhusuan_tpu.variational import SVGD as JSVGD
from zhusuan_tpu.variational import svgd as jsvgd
from zhusuan_tpu_torch.variational import SVGD, svgd

torch.set_num_threads(1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("bandwidth", ["median", 0.7])
def test_rbf_kernel_terms(bandwidth):
    x = np.random.default_rng(0).standard_normal((11, 4))
    want = jsvgd.rbf_kernel_terms(jnp.asarray(x), bandwidth)
    got = svgd.rbf_kernel_terms(torch.tensor(x), bandwidth)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def _median_cases():
    rng = np.random.default_rng(1)
    outlier = np.abs(rng.standard_normal(999)) + 0.5
    outlier = np.concatenate([outlier, [1e12]])
    return {
        "uniform": rng.uniform(0, 3, size=(37, 37)),
        "sqdist": np.square(rng.standard_normal((64, 64)) * 4.0),
        "outlier_1e12": outlier,
        "zeros": np.zeros(10),
        "ties": np.repeat([0.0, 1.0, 2.0], 7),
    }


@pytest.mark.parametrize("max_iters", [64, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(_median_cases()))
def test_median_bisect_is_jax_value(case, dtype, max_iters):
    # max_iters=3 stops every case (but the zeros) at the pass cap, 64 at
    # the relative test.
    x = _median_cases()[case].astype(dtype)
    want = np.asarray(jsvgd._median_bisect(jnp.asarray(x),
                                           max_iters=max_iters))
    got = svgd._median_bisect(torch.tensor(x), max_iters=max_iters)
    assert got.dtype == getattr(torch, dtype)
    assert _np(got) == want, (case, _np(got), want)
    if case == "outlier_1e12" and max_iters == 64:
        # Between the two middle values (to rel_tol), not near 1e12.
        lo, hi = np.sort(x)[len(x) // 2 - 1:len(x) // 2 + 1]
        assert lo * (1 - 1e-4) <= float(want) <= hi * (1 + 1e-4)


def test_median_bisect_stops_where_jax_does_not_torch_median():
    # An even count: torch.median takes the lower middle value, the
    # bisection converges between the two middle values.
    x = torch.tensor([0.0, 1.0, 3.0, 10.0], dtype=torch.float64)
    got = float(svgd._median_bisect(x))
    assert got == float(jsvgd._median_bisect(jnp.asarray(_np(x))))
    assert got != float(torch.median(x))


@pytest.mark.parametrize("init_acc", [0.1, 0.0])
def test_adagrad_matches_optax(init_acc):
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 2)), "b": rng.standard_normal(4)}
    jopt = optax.adagrad(0.05, initial_accumulator_value=init_acc)
    topt = svgd.adagrad(0.05, initial_accumulator_value=init_acc)
    js = jopt.init(params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = topt.init(tp)
    jp = params
    for i in range(30):
        g = {k: rng.standard_normal(v.shape) for k, v in params.items()}
        if i == 0:
            g["b"][0] = 0.0  # a zero accumulator where init_acc is 0
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts)
        tp = {k: v + tu[k] for k, v in tp.items()}
    for k in params:
        _close(tp[k], jp[k], 1e-12)
        _close(ts.sum_of_squares[k], js[0].sum_of_squares[k], 1e-12)


def j_log_joint(obs):
    w, b = obs["w"], obs["b"]
    x = jnp.asarray(_X)
    logits = w @ x.T + b[:, None]
    return (jnp.sum(_Y * jax.nn.log_sigmoid(logits)
                    + (1 - _Y) * jax.nn.log_sigmoid(-logits), axis=-1)
            - 0.5 * jnp.sum(w * w, axis=-1) - 0.5 * b * b)


def t_log_joint(obs):
    w, b = obs["w"], obs["b"]
    x = torch.tensor(_X)
    y = torch.tensor(_Y)
    logits = w @ x.T + b[:, None]
    return (torch.sum(y * torch.nn.functional.logsigmoid(logits)
                      + (1 - y) * torch.nn.functional.logsigmoid(-logits),
                      dim=-1)
            - 0.5 * torch.sum(w * w, dim=-1) - 0.5 * b * b)


_X = np.random.default_rng(3).standard_normal((20, 3))
_Y = (np.random.default_rng(4).uniform(size=20) < 0.5).astype(np.float64)


def _particles(n=12):
    rng = np.random.default_rng(5)
    return {"w": rng.standard_normal((n, 3)), "b": rng.standard_normal(n)}


@pytest.mark.parametrize("bandwidth", ["median", 1.5])
def test_svgd_30_updates(bandwidth):
    q0 = _particles()
    j = JSVGD(learning_rate=0.1, bandwidth=bandwidth)
    js, jdiag = j.run(j_log_joint, {}, j.init(q0), 30, collect=True)
    t = SVGD(learning_rate=0.1, bandwidth=bandwidth)
    ts, tdiag = t.run(t_log_joint, {},
                      t.init({k: torch.tensor(v) for k, v in q0.items()}),
                      30, collect=True)
    assert ts.t == 30
    for k in q0:
        _close(ts.particles[k], js.particles[k], 1e-8)
    _close(tdiag["bandwidth"], jdiag["bandwidth"], 1e-8)
    _close(tdiag["grad_norm"], jdiag["grad_norm"], 1e-8)
    _, info = t.update(t_log_joint, {}, ts)
    _, jinfo = j.update(j_log_joint, {}, js)
    _close(info.log_prob, jinfo.log_prob, 1e-8)


def test_svgd_state_round_trip_and_resume():
    q0 = _particles(6)
    j = JSVGD(learning_rate=0.05)
    js, _ = j.run(j_log_joint, {}, j.init(q0), 5)
    t = SVGD(learning_rate=0.05)
    ts = svgd.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert ts.t == 5
    back = svgd.state_from_numpy(svgd.state_to_numpy(ts), device="cpu")
    for k in q0:
        assert torch.equal(back.particles[k], ts.particles[k])
        assert torch.equal(back.opt_state.sum_of_squares[k],
                           ts.opt_state.sum_of_squares[k])
    js, _ = j.run(j_log_joint, {}, js, 5)
    ts, none = t.run(t_log_joint, {}, ts, 5)
    assert none is None
    for k in q0:
        _close(ts.particles[k], js.particles[k], 1e-8)


def test_svgd_errors():
    t = SVGD()
    with pytest.raises(ValueError, match="at least 2"):
        t.init({"w": torch.zeros(1, 3)})
    with pytest.raises(ValueError, match="share a leading"):
        t.init({"w": torch.zeros(4, 3), "b": torch.zeros(5)})
    with pytest.raises(ValueError, match="'median' or a positive"):
        SVGD(bandwidth="mean")
    with pytest.raises(ValueError, match="positive"):
        SVGD(bandwidth=0.0)
