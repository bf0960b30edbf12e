"""The port's L-BFGS (``zhusuan_tpu_torch/variational/_lbfgs.py``) against
``optax.lbfgs()`` at its defaults, in float64 on the CPU: each iterate and
each line search's step size within 1e-10 (absolute) while the gradient
norm is above 1e-6, and the line search's step counts equal. Past that the
two packages' iterates may part in the last bits (the gradient is at
round-off), so only the final point is held, at 1e-8.

Targets: a quadratic, Rosenbrock (5-d), a logistic regression, and a
log-barrier objective whose first trial step leaves its domain (a NaN
value: the decrease error becomes inf and the search zooms back)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zhusuan_tpu_torch.variational._lbfgs import (
    lbfgs,
    value_and_grad_from_state,
)

TOL = 1e-10
GRAD_FLOOR = 1e-6

_RNG = np.random.default_rng(3)
_A = _RNG.standard_normal((6, 6))
_H = _A @ _A.T + 0.5 * np.eye(6)
_B = _RNG.standard_normal(6)
_X = _RNG.standard_normal((40, 4))
_Y = (_X @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.3 * _RNG.standard_normal(40)
      > 0).astype(np.float64)


def _quadratic(m):
    h, b = m.asarray(_H), m.asarray(_B)
    return lambda x: 0.5 * m.sum(x * (h @ x)) - m.sum(b * x)


def _rosenbrock(m):
    return lambda x: m.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                           + (1.0 - x[:-1]) ** 2)


def _logistic(m):
    xs, ys = m.asarray(_X), m.asarray(_Y)
    if m is jnp:
        softplus = jax.nn.softplus
    else:
        softplus = torch.nn.functional.softplus
    return lambda w: (m.sum(softplus(xs @ w) - ys * (xs @ w))
                      + 0.5 * m.sum(w * w))


def _barrier(m):
    return lambda x: m.sum(x - 0.01 * m.log(x))


class _Torch:
    """The few ``jnp`` names the targets use, on float64 torch tensors."""

    sum = staticmethod(torch.sum)
    log = staticmethod(torch.log)

    @staticmethod
    def asarray(a):
        return torch.tensor(a, dtype=torch.float64)


CASES = {
    "quadratic": (_quadratic, np.zeros(6), 20),
    "rosenbrock": (_rosenbrock, np.array([-1.2, 1.0, -0.5, 0.8, 0.3]), 60),
    "logistic": (_logistic, np.zeros(4), 25),
    "barrier": (_barrier, np.array([0.8]), 30),
}


def _jax_run(fn, x0, n):
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(fn)

    @jax.jit
    def step(x, state):
        value, grad = vg(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=fn)
        return optax.apply_updates(x, updates), state, jnp.linalg.norm(grad)

    x = jnp.asarray(x0)
    state = opt.init(x)
    out = []
    for _ in range(n):
        x, state, gnorm = step(x, state)
        ls = state[-1]
        out.append((np.asarray(x), float(ls.learning_rate),
                    int(ls.info.num_linesearch_steps), float(gnorm)))
    return out


def _torch_run(fn, x0, n):
    opt = lbfgs()
    x = torch.tensor(x0)
    state = opt.init(x)
    vg = value_and_grad_from_state(fn)
    out = []
    for _ in range(n):
        value, grad = vg(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=fn)
        x = x + updates
        out.append((x.numpy().copy(), state.learning_rate, state.info))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_iterates_and_step_sizes_match_optax(case):
    make, x0, n = CASES[case]
    want = _jax_run(make(jnp), x0, n)
    got = _torch_run(make(_Torch), x0, n)
    held = 0
    for i, ((x, lr, info), (jx, jlr, jsteps, gnorm)) in enumerate(
            zip(got, want)):
        if gnorm < GRAD_FLOOR:
            break
        np.testing.assert_allclose(x, jx, rtol=0, atol=TOL,
                                   err_msg="iterate {}".format(i))
        assert abs(lr - jlr) <= TOL, (i, lr, jlr)
        assert info.num_linesearch_steps == jsteps, i
        assert info.host_reads == 1 + jsteps
        held += 1
    assert held >= 5
    np.testing.assert_allclose(got[-1][0], want[-1][0], rtol=0, atol=1e-8)


def test_zoom_and_domain_branches_are_reached():
    # Rosenbrock zooms (more than one line-search step in an iteration);
    # the barrier's unit step leaves the domain (a NaN value).
    make, x0, n = CASES["rosenbrock"]
    steps = [int(i.num_linesearch_steps)
             for _, _, i in _torch_run(make(_Torch), x0, n)]
    assert max(steps) > 2
    make, x0, n = CASES["barrier"]
    values = []

    def fn(x):
        values.append(float(make(_Torch)(x.detach())))
        return make(_Torch)(x)

    got = _torch_run(fn, x0, n)
    assert any(np.isnan(v) for v in values)
    assert all(np.isfinite(x).all() for x, _, _ in got)
    np.testing.assert_allclose(got[-1][0], 0.01, rtol=1e-10)


def test_state_reuse_and_memory_size():
    fn = _quadratic(_Torch)
    x = torch.zeros(6, dtype=torch.float64)
    opt = lbfgs()
    state = opt.init(x)
    vg = value_and_grad_from_state(fn)
    # No stored value yet: autograd at x.
    value, grad = vg(x, state=state)
    assert isinstance(value, torch.Tensor)
    updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                value_fn=fn)
    x = x + updates
    # The line search's value and gradient at its chosen point are reused.
    value2, grad2 = vg(x, state=state)
    assert value2 == state.value and grad2 is state.grad
    np.testing.assert_allclose(value2, float(fn(x)), rtol=1e-14)
    with pytest.raises(ValueError, match="memory_size"):
        lbfgs(memory_size=0)
