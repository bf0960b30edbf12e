"""Parity of the port's NeuTra transport (``zhusuan_tpu_torch/mcmc/
neutra.py``) with ``zhusuan_tpu/mcmc/neutra.py`` in float64 on the CPU:
20 ``fit_neutra`` steps from JAX's initial flow on JAX's draws (``split(key)
-> k_init, k_fit``; a step's normals from ``split(k_fit, n_iters)[i]``) at
1e-8, and the lifted density and coordinate maps at 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zhusuan_tpu import transform as jt
from zhusuan_tpu.mcmc import fit_neutra as j_fit_neutra
from zhusuan_tpu.mcmc import neutra_log_joint as j_neutra_log_joint
from zhusuan_tpu_torch import transform as tt
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import fit_neutra, neutra_log_joint

torch.set_num_threads(1)

D = 4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def j_funnel(obs):
    z = obs["z"]
    v, x = z[..., 0], z[..., 1:]
    return -0.5 * (v / 3.0) ** 2 + jnp.sum(
        -0.5 * (x / jnp.exp(v[..., None] / 2.0)) ** 2 - v[..., None] / 2.0,
        axis=-1)


def t_funnel(obs):
    z = obs["z"]
    v, x = z[..., 0], z[..., 1:]
    return -0.5 * (v / 3.0) ** 2 + torch.sum(
        -0.5 * (x / torch.exp(v[..., None] / 2.0)) ** 2 - v[..., None] / 2.0,
        dim=-1)


@pytest.mark.parametrize("n_flows,hidden,lr", [(2, 8, 2e-2), (3, 6, 5e-2)])
def test_fit_neutra_20_steps(n_flows, hidden, lr):
    key = jax.random.PRNGKey(5)
    n_iters, n_particles = 20, 16
    want = j_fit_neutra(j_funnel, "z", D, key, n_flows=n_flows,
                        hidden=hidden, n_iters=n_iters,
                        n_particles=n_particles, learning_rate=lr,
                        dtype=jnp.float64)
    k_init, k_fit = jax.random.split(key)
    init = jt.init_affine_coupling(k_init, n_flows, D, hidden=hidden,
                                   dtype=jnp.float64)
    noise = np.stack([
        np.asarray(jax.random.normal(k, (n_particles, D), jnp.float64))
        for k in jax.random.split(k_fit, n_iters)])
    got = fit_neutra(
        t_funnel, "z", D, n_flows=n_flows, hidden=hidden, n_iters=n_iters,
        n_particles=n_particles, learning_rate=lr,
        init_params=tt.params_from_numpy(jax.tree.map(np.asarray, init),
                                         device="cpu"),
        noise=noise)
    _close(got.losses, want.losses, 1e-8)
    for gp, wp in zip(got.params, want.params):
        for k in wp:
            _close(gp[k], wp[k], 1e-8)
    assert got.losses.shape == (n_iters,)


def test_fit_neutra_own_draws_and_errors():
    g = torch.Generator().manual_seed(0)
    res = fit_neutra(t_funnel, "z", D, g, n_flows=2, hidden=4, n_iters=5,
                     n_particles=8, dtype=torch.float64)
    assert len(res.params) == 2 and bool(torch.isfinite(res.losses).all())
    assert not res.params[0]["w1"].requires_grad
    with pytest.raises(ValueError, match="d >= 2"):
        fit_neutra(t_funnel, "z", 1, g)
    with pytest.raises(ValueError, match="noise must have shape"):
        fit_neutra(t_funnel, "z", D, g, n_iters=3, n_particles=2,
                   noise=np.zeros((2, 2, D)))


def _params():
    params = jax.tree.map(np.asarray, jt.init_affine_coupling(
        jax.random.PRNGKey(2), 4, D, hidden=6, dtype=jnp.float64))
    rng = np.random.default_rng(1)
    for p in params:
        for k in ("b1", "w2", "b2"):
            p[k] = 0.4 * rng.standard_normal(p[k].shape)
    return params


def test_neutra_log_joint_and_maps():
    params = _params()
    j_lj, j_to, j_from = j_neutra_log_joint(j_funnel, "z", params)
    t_lj, t_to, t_from = neutra_log_joint(
        t_funnel, "z", tt.params_from_numpy(params, device="cpu",
                                            requires_grad=False))
    y = np.random.default_rng(3).standard_normal((2, 5, D))
    ty = torch.tensor(y)
    _close(t_lj({"z": ty}), j_lj({"z": y}), 1e-12)
    _close(t_lj({"z": ty[0, 0]}), j_lj({"z": y[0, 0]}), 1e-12)  # rank 1
    _close(t_from(ty), j_from(y), 1e-12)
    _close(t_to(ty), j_to(y), 1e-12)
    _close(t_to(t_from(ty)), y, 1e-12)


def test_neutra_log_joint_of_a_meta_bayesian_net():
    params = _params()

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        bn.normal("z", torch.zeros(D, dtype=torch.float64), std=2.0,
                  group_ndims=1)
        return bn

    def j_model(obs):
        return jnp.sum(-0.5 * (obs["z"] / 2.0) ** 2 - jnp.log(2.0)
                       - 0.5 * jnp.log(2 * jnp.pi), axis=-1)

    t_lj, _, _ = neutra_log_joint(model(), "z", tt.params_from_numpy(
        params, device="cpu", requires_grad=False))
    j_lj, _, _ = j_neutra_log_joint(j_model, "z", params)
    y = np.random.default_rng(4).standard_normal((3, D))
    _close(t_lj({"z": torch.tensor(y)}), j_lj({"z": y}), 1e-12)
