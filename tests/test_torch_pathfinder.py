"""Parity of the port's Pathfinder (``zhusuan_tpu_torch/variational/
pathfinder.py``) with ``zhusuan_tpu/variational/pathfinder.py`` in float64
on the CPU, on the JAX package's own draws fed through ``noise=``: JAX's
``pathfinder(key)`` splits ``_, key_sweep, key_final = split(key, 3)`` and
draws ``normal(key_sweep, [n_elbo_draws, D])`` and ``normal(key_final,
[n_draws, D])``; ``multipath_pathfinder(key)`` gives path ``p`` the key
``split(key, n_paths + 1)[p]`` and draws its Gumbels from the last.

The draws, their log densities, the ELBO trace, the selected iterate and
its index, the pooled Pareto-k and the warm start are held at 1e-8
(relative to ``1 + |ref|``), on the JAX tests' targets
(``tests/test_pathfinder.py``): a correlated 5-d Gaussian, a two-latent
``MetaBayesianNet`` (sorted-name flattening, ``vmap`` over a model), a
scalar latent (the thin QR's ``K < 2m`` branch) and the multipath pool."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu.variational import multipath_pathfinder as j_multipath
from zhusuan_tpu.variational import pathfinder as j_pathfinder
from zhusuan_tpu.variational import pathfinder_mcmc_init as j_mcmc_init
from zhusuan_tpu_torch import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.variational import (
    multipath_pathfinder,
    pathfinder,
    pathfinder_mcmc_init,
)

TOL = 1e-8
F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=tol * (1.0 + np.abs(want[finite]).max()))


def _mvn(dim, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(dim, dim)
    cov = a @ a.T + dim * np.eye(dim)
    cov = cov / np.diag(cov).mean()
    mean = rng.randn(dim) * 2.0
    prec = np.linalg.inv(cov)

    def j_lj(obs):
        z = obs["z"] - jnp.asarray(mean)
        return -0.5 * jnp.einsum("...i,ij,...j->...", z, jnp.asarray(prec), z)

    def t_lj(obs):
        z = obs["z"] - torch.tensor(mean)
        return -0.5 * torch.einsum("...i,ij,...j->...", z, torch.tensor(prec),
                                   z)

    return j_lj, t_lj


def _path_noise(key, d, n_elbo, n_draws):
    _, key_sweep, key_final = jax.random.split(key, 3)
    return {"z_elbo": np.array(jax.random.normal(
                key_sweep, (n_elbo, d), jnp.float64)),
            "z": np.array(jax.random.normal(key_final, (n_draws, d),
                                              jnp.float64))}


def _hold_path(got, want):
    for k in want.draws:
        _close(got.draws[k], want.draws[k])
        _close(got.mode[k], want.mode[k])
    _close(got.log_p, want.log_p)
    _close(got.log_q, want.log_q)
    _close(got.elbo, want.elbo)
    _close(got.elbo_trace, want.elbo_trace)
    assert int(got.best_iter) == int(want.best_iter)


def test_gaussian_single_path():
    j_lj, t_lj = _mvn(5, 0)
    key = jax.random.PRNGKey(0)
    want = j_pathfinder(j_lj, {}, {"z": jnp.zeros(5)}, key, n_draws=400,
                        max_iters=30)
    got = pathfinder(t_lj, {}, {"z": torch.zeros(5, dtype=F64)},
                     n_draws=400, max_iters=30,
                     noise=_path_noise(key, 5, 30, 400))
    _hold_path(got, want)
    assert got.draws["z"].shape == (400, 5)
    # The warm start from the same draws.
    (ji, jm), (ti, tm) = j_mcmc_init(want, 64), pathfinder_mcmc_init(got, 64)
    _close(ti["z"], ji["z"])
    _close(tm["z"], jm["z"])
    assert tm["z"].shape == (1, 5)
    with pytest.raises(ValueError, match="exceeds"):
        pathfinder_mcmc_init(got, 401)


def _j_model():
    bn = zs.BayesianNet()
    mu = bn.normal("mu", jnp.float64(0.0), std=jnp.float64(2.0))
    b = bn.normal("b", jnp.float64(0.0), std=jnp.float64(1.0))
    bn.normal("y", (mu.tensor + 0.5 * b.tensor) * jnp.ones(3),
              std=jnp.float64(0.5), group_ndims=1)
    return bn


def _t_model():
    bn = BayesianNet()
    mu = bn.normal("mu", torch.tensor(0.0, dtype=F64), std=2.0)
    b = bn.normal("b", torch.tensor(0.0, dtype=F64), std=1.0)
    bn.normal("y", (mu.tensor + 0.5 * b.tensor) * torch.ones(3, dtype=F64),
              std=0.5, group_ndims=1)
    return bn


@pytest.mark.parametrize("case", ["meta_bn", "scalar"])
def test_model_and_scalar_latents(case):
    key = jax.random.PRNGKey(2 if case == "meta_bn" else 3)
    if case == "meta_bn":
        y = np.array([1.1, 0.9, 1.3])
        j_args = (zs.meta_bayesian_net()(_j_model)(), {"y": jnp.asarray(y)},
                  {"mu": jnp.float64(0.0), "b": jnp.float64(0.0)})
        t_args = (meta_bayesian_net()(_t_model)(), {"y": torch.tensor(y)},
                  {"mu": torch.tensor(0.0, dtype=F64),
                   "b": torch.tensor(0.0, dtype=F64)})
        d = 2
    else:
        j_args = (lambda o: -0.5 * ((o["z"] - 3.0) / 0.5) ** 2, {},
                  {"z": jnp.float64(0.0)})
        t_args = (lambda o: -0.5 * ((o["z"] - 3.0) / 0.5) ** 2, {},
                  {"z": torch.tensor(0.0, dtype=F64)})
        d = 1
    want = j_pathfinder(*j_args, key, n_draws=300, max_iters=25)
    got = pathfinder(*t_args, n_draws=300, max_iters=25,
                     noise=_path_noise(key, d, 30, 300))
    _hold_path(got, want)


def test_multipath_pool():
    j_lj, t_lj = _mvn(4, 2)
    n_paths, per_path, n_draws = 4, 150, 300
    inits = np.array(jax.random.normal(jax.random.PRNGKey(9),
                                         (n_paths, 4), jnp.float64)) * 3.0
    key = jax.random.PRNGKey(4)
    want = j_multipath(j_lj, {}, {"z": jnp.asarray(inits)}, key,
                       n_draws=n_draws, n_draws_per_path=per_path,
                       max_iters=20)
    keys = jax.random.split(key, n_paths + 1)
    paths = [_path_noise(k, 4, 30, per_path) for k in keys[:n_paths]]
    noise = {"z_elbo": np.stack([p["z_elbo"] for p in paths]),
             "z": np.stack([p["z"] for p in paths]),
             "gumbel": np.array(jax.random.gumbel(
                 keys[-1], (n_paths * per_path,), jnp.float64))}
    got = multipath_pathfinder(t_lj, {}, {"z": torch.tensor(inits)},
                               n_draws=n_draws, n_draws_per_path=per_path,
                               max_iters=20, noise=noise)
    _close(got.draws["z"], want.draws["z"])
    _close(got.log_p, want.log_p)
    _close(got.path_elbos, want.path_elbos)
    assert abs(got.khat - want.khat) <= TOL * (1 + abs(want.khat))


def test_own_draws_and_errors():
    _, t_lj = _mvn(3, 1)
    a = pathfinder(t_lj, {}, {"z": torch.zeros(3, dtype=F64)},
                   torch.Generator().manual_seed(0), n_draws=50,
                   max_iters=15)
    b = pathfinder(t_lj, {}, {"z": torch.zeros(3, dtype=F64)},
                   torch.Generator().manual_seed(0), n_draws=50,
                   max_iters=15)
    assert torch.equal(a.draws["z"], b.draws["z"])
    assert bool(torch.isfinite(a.log_q).all())
    res = multipath_pathfinder(t_lj, {}, {"z": torch.zeros(2, 3, dtype=F64)},
                               torch.Generator().manual_seed(1), n_draws=40,
                               n_draws_per_path=30, max_iters=10)
    assert res.draws["z"].shape == (40, 3) and res.path_elbos.shape == (2,)
    with pytest.raises(ValueError, match="UNBATCHED"):
        pathfinder(t_lj, {}, {"z": torch.zeros(4, 3, dtype=F64)})
    with pytest.raises(ValueError, match="pooled"):
        multipath_pathfinder(t_lj, {}, {"z": torch.zeros(2, 3, dtype=F64)},
                             n_draws=100, n_draws_per_path=10, max_iters=5)
    with pytest.raises(ValueError, match="unbatched"):
        multipath_pathfinder(t_lj, {}, {"z": torch.zeros(2, 4, 3,
                                                         dtype=F64)})


@pytest.mark.cuda
def test_warm_start_feeds_the_hmc_kernel():
    """``pathfinder_mcmc_init`` -> ``HMC.init(...)._replace(mass=mass)`` ->
    ``HMC.run`` on a built-in density takes K1 every iteration, and K1's
    step from the warm start agrees with its plain version chain for
    chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    import zhusuan_tpu_torch as zt
    from zhusuan_tpu_torch.ops.hmc_step import (
        fused_hmc_step, fused_hmc_step_reference,
    )
    dev = torch.device("cuda", 0)
    d = 16
    std = torch.linspace(0.1, 1.0, d, dtype=F64, device=dev)
    dens = zt.DiagonalGaussianLogJoint("x", torch.zeros(d, dtype=F64,
                                                        device=dev), std)
    res = multipath_pathfinder(
        dens, {}, {"x": torch.randn(2, d, dtype=F64, device=dev)},
        torch.Generator().manual_seed(0), n_draws=512, n_draws_per_path=512,
        max_iters=30)
    init, mass = pathfinder_mcmc_init(res, 256)
    dens32 = zt.DiagonalGaussianLogJoint("x", torch.zeros(d, device=dev),
                                         std.float())
    hmc = zt.HMC(step_size=0.3, n_leapfrogs=5, experimental_fused_step=True)
    state = hmc.init({"x": init["x"].float()}, n_chain_dims=1)._replace(
        mass={"x": mass["x"].float()})
    fused_hmc_step.launches = 0
    state, _ = hmc.run(dens32, {}, state, torch.Generator().manual_seed(1),
                       20)
    assert fused_hmc_step.launches == 20
    g = torch.Generator(device=dev).manual_seed(2)
    noise = (torch.randn(256, d, generator=g, device=dev),
             torch.rand(256, generator=g, device=dev))
    got = fused_hmc_step(dens32, state.q["x"], state.mass["x"],
                         state.step_size, 5, (1, 2), 21, noise=noise)
    want = fused_hmc_step_reference(dens32, state.q["x"], state.mass["x"],
                                    state.step_size, 5, (1, 2), 21,
                                    noise=noise)
    assert int(((noise[1] < got[2]) != (noise[1] < want[2])).sum()) == 0
