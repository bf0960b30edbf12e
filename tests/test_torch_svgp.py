"""Parity tests of zhusuan_tpu_torch's SVGP training path
(``examples/gaussian_process``) against the JAX package's example, on the
CPU.

Both packages get the same data and parameters from numpy. The JAX example
draws its variational ``fz`` and ``fx`` from ``fold_in(key, crc32(name))``;
:func:`_draws` rebuilds those standard normals and the port takes them
through ``noise=``. In float64 the loss and every parameter gradient agree
to 1e-10 and five chained Adam steps to 1e-8. In float32 the JAX side runs
its Pallas Cholesky-plus-inverse kernel (K10) in interpret mode, as
``tests/test_ops_linalg.py`` does, against the port's plain version, within
that file's 1e-4 on the value and 3e-3 on the gradients. The CUDA kernel is
held to the plain version on the card (``tests/test_torch_ops_linalg.py``'s
``cuda`` tests and ``chip_smoke.py`` phases 14-15).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
from baseline_ref import configs_protocol as protocol
from examples.gaussian_process import svgp as jsvgp
from examples.gaussian_process import utils as jgp
from examples.utils import dataset as jdataset
from zhusuan_tpu.ops import linalg as zlin
from zhusuan_tpu.utils import log_mean_exp as jlog_mean_exp
from zhusuan_tpu_torch.examples.gaussian_process import svgp as tsvgp
from zhusuan_tpu_torch.examples.gaussian_process import utils as tgp
from zhusuan_tpu_torch.ops import linalg as tlin

torch.set_num_threads(1)

N_Z, P, N_X, X_DIM, N_TRAIN = 8, 6, 30, 3, 40
TOL_VALUE = 1e-10  # float64, one loss and its gradients
TOL_CHAIN = 1e-8  # float64, five chained Adam steps
TOL_F32 = (1e-4, 3e-3)  # value, gradients (tests/test_ops_linalg.py:238-243)


def _data(dtype=np.float64):
    rng = np.random.RandomState(0)
    x = rng.randn(N_X, X_DIM)
    return x.astype(dtype), np.sin(x.sum(-1)).astype(dtype)


def _draws(key, n_x, n_particles=P, dtype=jnp.float64):
    """The standard normals of the JAX example's variational nodes."""
    def normal(name, shape):
        k = jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))
        return np.asarray(jax.random.normal(k, shape, dtype))

    return {"fz": normal("fz", (n_particles, N_Z)),
            "fx": normal("fx", (1, n_particles, n_x))[0]}


def _jax_loss(params, x, y, key, fused, n_train=N_TRAIN):
    """The JAX example's loss_fn (examples/gaussian_process/svgp.py:172)."""
    if fused:
        chol, chol_inv = jsvgp.kzz_factors(params, N_Z)
    else:
        chol, chol_inv = jsvgp.kzz_cholesky(params, N_Z), None
    model = jsvgp.build_model(params, x, N_Z, P, kzz_chol=chol,
                              kzz_chol_inv=chol_inv)

    def log_joint(bn):
        prior, log_py = bn.cond_log_prob(["fz", "y"])
        return prior + log_py / x.shape[0] * n_train

    model.log_joint = log_joint
    latent = jsvgp.build_variational_samples(params, x, N_Z, P, key,
                                             kzz_chol=chol,
                                             kzz_chol_inv=chol_inv)
    lb = zs.variational.elbo(model, observed={"y": y}, latent=latent,
                             axis=0)
    return jnp.mean(lb.sgvb()), jnp.mean(lb.tensor)


def _jax_params(x):
    return jsvgp.init_params(jax.random.PRNGKey(0), N_Z, X_DIM, x)


def _torch_params(jparams, dtype=None):
    return tsvgp.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
        dtype=dtype)


def _noise(draws):
    return {k: torch.tensor(np.array(v)) for k, v in draws.items()}


def _close(got, want, tol, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=err_msg)


# --------------------------------------------------------------------- #
# GP utilities
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("given", ["none", "chol", "chol_and_inv"])
def test_gp_conditional_matches_jax(full_cov, given):
    rng = np.random.RandomState(1)
    z, x = rng.randn(N_Z, X_DIM), rng.randn(5, X_DIM)
    fz, raw = rng.randn(P, N_Z), rng.randn(X_DIM) * 0.5
    jk, tk = jgp.RBFKernel(jnp.asarray(raw)), tgp.RBFKernel(torch.tensor(raw))
    _close(tk(torch.tensor(z), torch.tensor(x)),
           jk(jnp.asarray(z), jnp.asarray(x)), 1e-12)
    kzz = np.asarray(jk(jnp.asarray(z), jnp.asarray(z))) + 1e-6 * np.eye(N_Z)
    chol = np.linalg.cholesky(kzz)
    jkw, tkw = {}, {}
    if given != "none":
        jkw["Kzz_chol"], tkw["Kzz_chol"] = jnp.asarray(chol), torch.tensor(
            chol)
    if given == "chol_and_inv":
        inv = np.linalg.inv(chol)
        jkw["Kzz_chol_inv"] = jnp.asarray(inv)
        tkw["Kzz_chol_inv"] = torch.tensor(inv)
    jd = jgp.gp_conditional(jnp.asarray(z), jnp.asarray(fz), jnp.asarray(x),
                            full_cov, jk, **jkw)
    td = tgp.gp_conditional(torch.tensor(z), torch.tensor(fz),
                            torch.tensor(x), full_cov, tk, **tkw)
    assert type(td).__name__ == type(jd).__name__
    given_x = rng.randn(P, 5)
    _close(td.log_prob(torch.tensor(given_x)),
           jd.log_prob(jnp.asarray(given_x)), 1e-9)
    _close(td.mean, jd.mean, 1e-10)


# --------------------------------------------------------------------- #
# The loss, its gradients and training, float64
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_gradients_match_jax(fused):
    """``kzz_factors`` (fused) and ``kzz_cholesky`` (plain) paths: the
    loss, the mean bound and every parameter gradient within 1e-10."""
    x, y = _data()
    jparams = _jax_params(x)
    key = jax.random.PRNGKey(7)
    (jl, jlb), jg = jax.value_and_grad(
        lambda p: _jax_loss(p, jnp.asarray(x), jnp.asarray(y), key, fused),
        has_aux=True)(jparams)
    params = _torch_params(jparams)
    tl, tlb = tsvgp.elbo_loss(params, torch.tensor(x), torch.tensor(y), N_Z,
                              P, N_TRAIN, None, chol_inverse=fused,
                              noise=_noise(_draws(key, N_X)))
    tl.backward()
    _close(tl, jl, TOL_VALUE)
    _close(tlb, jlb, TOL_VALUE)
    for k in tsvgp.PARAM_NAMES:
        _close(params[k].grad, jg[k], TOL_VALUE, err_msg=k)


def test_five_adam_steps_match_jax():
    x, y = _data()
    jparams = _jax_params(x)
    params = _torch_params(jparams)
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(jparams)
    topt = tsvgp.make_optimizer(params, 1e-2)
    key = jax.random.PRNGKey(3)
    for _ in range(5):
        key, sub = jax.random.split(key)
        (_, jlb), grads = jax.value_and_grad(
            lambda p: _jax_loss(p, jnp.asarray(x), jnp.asarray(y), sub, True),
            has_aux=True)(jparams)
        updates, opt_state = optimizer.update(grads, opt_state)
        jparams = optax.apply_updates(jparams, updates)
        tlb = tsvgp.train_step(params, topt, torch.tensor(x),
                               torch.tensor(y), N_Z, P, N_TRAIN, None,
                               noise=_noise(_draws(sub, N_X)))
        _close(tlb, jlb, TOL_CHAIN)
        assert not tlb.requires_grad
    for k in tsvgp.PARAM_NAMES:
        _close(params[k], jparams[k], TOL_CHAIN, err_msg=k)


def test_predict_matches_jax():
    x, y = _data()
    jparams = _jax_params(x)
    rng = np.random.RandomState(5)
    jparams = {k: v + 0.1 * rng.randn(*np.shape(v)) for k, v in
               jparams.items()}
    xt, yt = x[:12], y[:12]
    std_y, n_test = 1.7, 9
    key = jax.random.PRNGKey(4)
    k_q, k_m = jax.random.split(key)
    latent = jsvgp.build_variational_samples(jparams, jnp.asarray(xt), N_Z,
                                             n_test, k_q)
    model = jsvgp.build_model(jparams, jnp.asarray(xt), N_Z, n_test)
    bn = model.observe(k_m, fx=latent["fx"][0], y=jnp.asarray(yt))
    jll = jnp.mean(jlog_mean_exp(bn.cond_log_prob("y"), 0) / 12) - np.log(
        std_y)
    jrmse = jnp.sqrt(jnp.mean((jnp.mean(bn["y"].dist.mean, 0) - yt) ** 2)) \
        * std_y
    rmse, ll = tsvgp.predict(_torch_params(jparams), torch.tensor(xt),
                             torch.tensor(yt), N_Z, n_test, std_y, (1, 2),
                             noise=_noise(_draws(k_q, 12, n_test)))
    _close(rmse, jrmse, TOL_VALUE)
    _close(ll, jll, TOL_VALUE)


# --------------------------------------------------------------------- #
# Float32: the JAX side's Pallas K10 in interpret mode
# --------------------------------------------------------------------- #
@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(zlin, "_FORCE_INTERPRET", True)


def test_float32_loss_matches_interpreted_pallas_kernel(interpret_kernel):
    x, y = _data(np.float32)
    jparams = _jax_params(x)
    assert jparams["z_pos"].dtype == jnp.float32
    key = jax.random.PRNGKey(7)
    (jl, _), jg = jax.value_and_grad(
        lambda p: _jax_loss(p, jnp.asarray(x), jnp.asarray(y), key, True),
        has_aux=True)(jparams)
    params = _torch_params(jparams)
    assert params["z_pos"].dtype == torch.float32
    tl, _ = tsvgp.elbo_loss(params, torch.tensor(x), torch.tensor(y), N_Z, P,
                            N_TRAIN, None,
                            noise=_noise(_draws(key, N_X, dtype=jnp.float32)))
    tl.backward()
    _close(tl, jl, TOL_F32[0])
    for k in tsvgp.PARAM_NAMES:
        _close(params[k].grad, jg[k], TOL_F32[1], err_msg=k)


# --------------------------------------------------------------------- #
# Parameters, data and the entry point
# --------------------------------------------------------------------- #
def test_init_params_and_numpy_round_trip():
    x, _ = _data(np.float32)
    jparams = _jax_params(x)
    params = tsvgp.init_params(N_Z, X_DIM, x, device="cpu")
    assert all(params[k].requires_grad and params[k].is_leaf
               for k in tsvgp.PARAM_NAMES)
    arrays = tsvgp.params_to_numpy(params)
    assert set(arrays) == set(jparams) == set(tsvgp.PARAM_NAMES)
    for k in tsvgp.PARAM_NAMES:
        assert arrays[k].dtype == np.asarray(jparams[k]).dtype
        np.testing.assert_array_equal(arrays[k], np.asarray(jparams[k]))
    back = tsvgp.params_to_numpy(tsvgp.params_from_numpy(arrays,
                                                         device="cpu"))
    for k in tsvgp.PARAM_NAMES:
        np.testing.assert_array_equal(back[k], arrays[k])
    f64 = tsvgp.params_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert f64["z_mean"].dtype == torch.float64


def test_data_helpers_match_the_repositorys(monkeypatch, tmp_path):
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))
    for got, want in zip(tsvgp.regression_splits(tsvgp.SVGP_CONFIG),
                         protocol.regression_splits(protocol.SVGP)):
        np.testing.assert_array_equal(got, want)
    assert {k: tsvgp.SVGP_CONFIG[k] for k in protocol.SVGP} == protocol.SVGP
    a = np.random.RandomState(0).randn(20, 4)
    for got, want in zip(tsvgp.standardize(a[:15], a[15:]),
                         jdataset.standardize(a[:15], a[15:])):
        np.testing.assert_array_equal(got, want)
    for name in ("load_uci_boston_housing", "load_uci_protein_data"):
        got, want = getattr(tsvgp, name)(), getattr(jdataset, name)()
        assert got[-1] is True and want[-1] is True
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(g, w)


def test_cpu_factors_never_launch():
    x, _ = _data(np.float32)
    params = tsvgp.init_params(N_Z, X_DIM, x, device="cpu")
    before = tlin.cholesky_inverse.launches
    chol, chol_inv = tsvgp.kzz_factors(params, N_Z)
    assert tlin.cholesky_inverse.launches == before
    torch.testing.assert_close(chol, tsvgp.kzz_cholesky(params, N_Z))
    torch.testing.assert_close(chol @ chol_inv, torch.eye(N_Z), atol=1e-5,
                               rtol=0)


def test_main_trains_on_the_cpu_only_when_asked(monkeypatch, tmp_path,
                                                capsys):
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))
    assert tsvgp._device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tsvgp.main(["-n_epoch", "1"])
    params = tsvgp.main(["-n_epoch", "100", "-n_z", "8", "-n_particles", "2",
                         "-n_particles_test", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "synthetic" in out and "Epoch 100: lower bound" in out
    assert params["z_pos"].device.type == "cpu"
    assert all(torch.isfinite(params[k]).all() for k in tsvgp.PARAM_NAMES)
