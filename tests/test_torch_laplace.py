"""Parity of the port's Laplace approximation
(``zhusuan_tpu_torch/variational/laplace.py``) with
``zhusuan_tpu/variational/laplace.py`` in float64 on the CPU, on the JAX
tests' cases (``tests/variational/test_laplace.py``): the mode, the
Cholesky factor of the Hessian, the log evidence and the log joint at the
mode within 1e-8 (relative to ``1 + |ref|``; L-BFGS's iterates are held at
1e-10 by ``tests/test_torch_lbfgs.py``, and here every step runs, also
those where the gradient has reached round-off), the plain-optimizer split
(``optax.adagrad`` against the port's ``svgd.adagrad``), the indefinite
Hessian's flag and NaN evidence, and the unbatched-latent error."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zhusuan_tpu.bijectors import Softplus as JSoftplus
from zhusuan_tpu.bijectors import transform_log_joint as j_transform
from zhusuan_tpu.variational import laplace_approximation as j_laplace
from zhusuan_tpu_torch.bijectors import Softplus, transform_log_joint
from zhusuan_tpu_torch.variational import laplace_approximation
from zhusuan_tpu_torch.variational.svgd import adagrad

TOL = 1e-8
LOG_2PI = math.log(2 * math.pi)
SIGMA, X_OBS = 0.6, 1.3
_COV = np.array([[2.0, 0.6], [0.6, 1.0]])
_PREC = np.linalg.inv(_COV)
_LD = float(np.linalg.slogdet(_COV)[1])
_XL = np.array([0.5, -1.2, 2.0, 0.3, -0.7])
_YL = np.array([1.0, 0.0, 1.0, 1.0, 0.0])


def _conjugate(m):
    def log_joint(obs):
        z = obs["z"]
        return (-0.5 * z ** 2 - 0.5 * LOG_2PI
                - 0.5 * ((X_OBS - z) / SIGMA) ** 2 - math.log(SIGMA)
                - 0.5 * LOG_2PI)
    return log_joint


def _two_blocks(m):
    prec = m.asarray(_PREC)

    def log_joint(obs):
        a, b = obs["a"], obs["b"]
        lp = -0.5 * m.sum((a - 1.0) * (prec @ (a - 1.0)))
        lp = lp - 0.5 * (_LD + 2 * LOG_2PI)
        return lp + m.sum(-0.5 * ((b + 2.0) / 0.5) ** 2 - math.log(0.5)
                          - 0.5 * LOG_2PI)
    return log_joint


def _logistic(m):
    xs, ys = m.asarray(_XL), m.asarray(_YL)

    def log_joint(obs):
        w = obs["w"]
        logits = w * xs
        return (-0.5 * w ** 2 - 0.5 * LOG_2PI
                + m.sum(ys * m.log_sigmoid(logits)
                        + (1 - ys) * m.log_sigmoid(-logits)))
    return log_joint


def _scale(m):
    def log_joint(obs):
        s = obs["sigma"]
        return -s - 0.5 * (0.8 / s) ** 2 - m.log(s) - 0.5 * LOG_2PI
    return log_joint


def _wrong_sign(m):
    return lambda obs: 0.5 * m.sum(obs["z"] ** 2)


class J:
    sum = staticmethod(jnp.sum)
    log = staticmethod(jnp.log)
    log_sigmoid = staticmethod(jax.nn.log_sigmoid)

    @staticmethod
    def asarray(a):
        return jnp.asarray(a, jnp.float64)


class T:
    sum = staticmethod(torch.sum)
    log = staticmethod(torch.log)
    log_sigmoid = staticmethod(torch.nn.functional.logsigmoid)

    @staticmethod
    def asarray(a):
        return torch.tensor(a, dtype=torch.float64)


CASES = {
    "conjugate": (_conjugate, {"z": np.float64(0.0)}, 100),
    "two_blocks": (_two_blocks, {"a": np.zeros(2), "b": np.zeros(3)}, 200),
    "logistic": (_logistic, {"w": np.float64(0.0)}, 200),
    "wrong_sign": (_wrong_sign, {"z": np.ones(2)}, 5),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want[np.isfinite(want)]).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * (1.0 + scale))


def _hold(got, want):
    for k in want.mode:
        _close(got.mode[k], want.mode[k])
    _close(got.chol_precision, want.chol_precision)
    _close(got.log_evidence, want.log_evidence)
    _close(got.log_post_mode, want.log_post_mode)
    assert bool(got.pd_hessian) == bool(want.pd_hessian)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    make, init, n_iters = CASES[case]
    want = j_laplace(make(J), {}, {k: jnp.asarray(v)
                                   for k, v in init.items()}, n_iters=n_iters)
    got = laplace_approximation(make(T), {}, {k: torch.tensor(v)
                                              for k, v in init.items()},
                                n_iters=n_iters)
    _hold(got, want)
    if case == "wrong_sign":
        assert not bool(got.pd_hessian)
        assert math.isnan(float(got.log_evidence))
    else:
        assert bool(got.pd_hessian)
    if case == "conjugate":
        # Laplace is exact here.
        true_log_z = (-0.5 * math.log(2 * math.pi * (1 + SIGMA ** 2))
                      - 0.5 * X_OBS ** 2 / (1 + SIGMA ** 2))
        np.testing.assert_allclose(float(got.log_evidence), true_log_z,
                                   rtol=1e-6)
        assert float(got.grad_norm) < 1e-6


def test_constrained_via_bijector():
    ulj_j, to_u_j, to_c_j = j_transform(_scale(J), {"sigma": JSoftplus()})
    want = j_laplace(ulj_j, {}, to_u_j({"sigma": jnp.float64(1.0)}),
                     n_iters=300)
    ulj, to_u, to_c = transform_log_joint(_scale(T), {"sigma": Softplus()})
    got = laplace_approximation(
        ulj, {}, to_u({"sigma": torch.tensor(1.0, dtype=torch.float64)}),
        n_iters=300)
    _hold(got, want)
    _close(to_c(got.mode)["sigma"], to_c_j(want.mode)["sigma"])


def test_plain_optimizer():
    # optax.adagrad (no line search: the plain branch) against the port's
    # copy of it, on the same 300 steps.
    def j_lj(obs):
        return -0.5 * jnp.sum((obs["z"] - 2.0) ** 2)

    def t_lj(obs):
        return -0.5 * torch.sum((obs["z"] - 2.0) ** 2)

    want = j_laplace(j_lj, {}, {"z": jnp.zeros(3, jnp.float64)},
                     n_iters=300, optimizer=optax.adagrad(0.5))
    got = laplace_approximation(t_lj, {}, {"z": torch.zeros(
        3, dtype=torch.float64)}, n_iters=300, optimizer=adagrad(0.5))
    _hold(got, want)
    np.testing.assert_allclose(_np(got.mode["z"]), 2.0, atol=1e-3)


def test_batched_latent_rejected():
    with pytest.raises(ValueError, match="UNBATCHED"):
        laplace_approximation(lambda o: -0.5 * torch.sum(o["z"] ** 2, -1),
                              {}, {"z": torch.zeros(4, 2)})
