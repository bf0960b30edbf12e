"""Parity tests of the port's VAE and IWAE examples
(``zhusuan_tpu_torch/examples/variational_autoencoders``) and of its MLP
helpers (``examples/utils/nn.py``) against the JAX package's, on the CPU in
float64 at a small size (x_dim 16, hidden 8, z 4).

The JAX weights cross over through ``params_from_numpy``; each step's draws
of the variational ``z`` are rebuilt from the JAX key (``fold_in(key,
crc32("z"))``) and fed through ``noise=``. One loss and its gradients hold
to 1e-10; five chained Adam steps to 1e-8.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.utils import nn as jnn
from examples.variational_autoencoders import iwae as jiwae
from examples.variational_autoencoders import vae as jvae
from zhusuan_tpu_torch import fit as tfit
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.examples.variational_autoencoders import iwae as tiwae
from zhusuan_tpu_torch.examples.variational_autoencoders import vae as tvae
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
TOL_CHAIN = 1e-8
X_DIM, HIDDEN, Z_DIM, N = 16, 8, 4, 6
N_STEPS = 5


def _close(got, want, tol=TOL):
    got, want = (v.detach().numpy() if isinstance(v, torch.Tensor) else v
                 for v in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _grads_close(params, jax_grads, tol=TOL):
    def one(want, leaf):
        assert leaf.grad is not None and leaf.grad.shape == want.shape
        _close(leaf.grad, want, tol)

    assert len(tree_leaves(params)) == len(jax.tree.leaves(jax_grads))
    jax.tree.map(one, jax_grads, params)


def _z_noise(key, n_particles, n=N):
    k = jax.random.fold_in(key, zlib.crc32(b"z"))
    return {"z": torch.tensor(np.asarray(jax.random.normal(
        k, (n_particles, n, Z_DIM), jnp.float64)))}


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, X_DIM) < 0.5).astype(np.float64)


def _params():
    p = jvae.init_params(jax.random.PRNGKey(5), X_DIM, Z_DIM, HIDDEN)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
    return jp, tnn.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


# --------------------------------------------------------------------- #
# MLP helpers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("final", [None, "relu"])
def test_mlp_apply_matches_jax(final):
    jp, tp = _params()
    x = np.random.RandomState(2).randn(3, N, X_DIM)
    want = jnn.mlp_apply(jp["encoder"], jnp.asarray(x),
                         final_activation=jax.nn.relu if final else None)
    got = tnn.mlp_apply(tp["encoder"], torch.tensor(x),
                        final_activation=torch.relu if final else None)
    _close(got, want, 1e-12)
    _close(tnn.linear_apply(tp["z_mean"], torch.tensor(x[..., :HIDDEN])),
           jnn.linear_apply(jp["z_mean"], jnp.asarray(x[..., :HIDDEN])),
           1e-12)


def test_mlp_apply_bfloat16_compute_matches_jax():
    """``compute_dtype=bfloat16``: the product in bfloat16, the output back
    in the input's dtype; held to bfloat16's resolution."""
    jp, tp = _params()
    x = np.random.RandomState(3).randn(N, X_DIM).astype(np.float32)
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    tp32 = tnn.params_from_numpy(jax.tree.map(np.asarray, jp32),
                                 device="cpu")
    want = jnn.mlp_apply(jp32["encoder"], jnp.asarray(x),
                         compute_dtype=jnp.bfloat16)
    got = tnn.mlp_apply(tp32["encoder"], torch.tensor(x),
                        compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-2, atol=2e-2)


def test_init_shapes_scale_and_round_trip():
    g = torch.Generator().manual_seed(0)
    params = tvae.init_params(g, 784, 40, 500)
    jax.tree.map(lambda a, t: _close(t.shape, a.shape, 0),
                 jvae.init_params(jax.random.PRNGKey(0), 784, 40, 500),
                 params)
    w = params["encoder"][0]["w"]
    assert w.dtype == torch.float32 and w.requires_grad and w.is_leaf
    np.testing.assert_allclose(float(w.detach().std()), np.sqrt(2.0 / 784),
                               rtol=0.02)
    assert params["encoder"][0]["b"].detach().abs().max().item() == 0.0
    again = tvae.init_params(torch.Generator().manual_seed(0), 784, 40, 500)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  tree_leaves(again)))
    arrays = tnn.params_to_numpy(params)
    back = tnn.params_from_numpy(arrays, device="cpu")
    assert all(torch.equal(a, b) and b.requires_grad
               for a, b in zip(tree_leaves(params), tree_leaves(back)))
    f64 = tnn.params_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert f64["decoder"][2]["w"].dtype == torch.float64


# --------------------------------------------------------------------- #
# Losses and gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_particles", [1, 3])
def test_elbo_loss_and_gradients_match_jax(n_particles):
    x = _data()
    jp, tp = _params()
    key = jax.random.PRNGKey(9)
    jloss, jgrads = jax.value_and_grad(jvae.elbo_loss)(
        jp, jnp.asarray(x), key, Z_DIM, n_particles)
    loss = tvae.elbo_loss(tp, torch.tensor(x), 0, Z_DIM, n_particles,
                          noise=_z_noise(key, n_particles))
    loss.backward()
    _close(loss, jloss)
    _grads_close(tp, jgrads)


def test_iwae_loss_and_gradients_match_jax():
    x = _data()
    jp, tp = _params()
    key = jax.random.PRNGKey(10)
    jloss, jgrads = jax.value_and_grad(jiwae.iwae_loss)(
        jp, jnp.asarray(x), key, Z_DIM, 4)
    loss = tiwae.iwae_loss(tp, torch.tensor(x), 0, Z_DIM, 4,
                           noise=_z_noise(key, 4))
    loss.backward()
    _close(loss, jloss)
    _grads_close(tp, jgrads)


# --------------------------------------------------------------------- #
# Chained train steps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("example,n_particles", [("vae", 1), ("iwae", 3)])
def test_five_train_steps_match_jax(example, n_particles):
    jmod, tmod = (jvae, tvae) if example == "vae" else (jiwae, tiwae)
    jp, tp = _params()
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jp)
    jstep = jmod.make_train_step(jopt, Z_DIM, n_particles)
    topt = torch.optim.Adam(tree_leaves(tp), lr=1e-3)
    tstep = tmod.make_train_step(topt, Z_DIM, n_particles)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(4),
                                             N_STEPS)):
        x = _data(seed=10 + i)
        jp, jstate, jlb = jstep(jp, jstate, jnp.asarray(x), key)
        lb = tstep(tp, torch.tensor(x), i,
                   noise=_z_noise(key, n_particles))
        assert not lb.requires_grad
        _close(lb, jlb, TOL_CHAIN)
    jax.tree.map(lambda w, t: _close(t, w, TOL_CHAIN), jp, tp)


# --------------------------------------------------------------------- #
# The port's training-loop pieces
# --------------------------------------------------------------------- #
def test_fit_loss_binarizes_from_the_step_generator():
    """``fit_loss(binarize=True)`` draws ``u < x`` from the step's
    generator, then keys the variational net with its seed."""
    _, tp = _params()
    x_real = torch.tensor(np.random.RandomState(1).rand(N, X_DIM))
    gen = torch.Generator().manual_seed(123)
    got = tvae.fit_loss(Z_DIM, binarize=True)(tp, x_real, gen)
    g2 = torch.Generator().manual_seed(123)
    x_bin = (torch.rand(x_real.shape, generator=g2, dtype=x_real.dtype)
             < x_real).to(x_real.dtype)
    _close(got, tvae.elbo_loss(tp, x_bin, 123, Z_DIM), 0)


def test_fit_scan_trains_the_vae_on_the_cpu():
    _, tp = _params()
    data = torch.tensor(_data(seed=3, n=40))
    opt = torch.optim.Adam(tree_leaves(tp), lr=1e-2)
    _, _, hist = tfit.fit_scan(tvae.fit_loss(Z_DIM), tp, opt, data,
                               generator=torch.Generator().manual_seed(0),
                               epochs=3, batch_size=8)
    assert hist.shape == (3, 5) and np.isfinite(hist).all()


def test_eval_is_loglikelihood_is_the_batches_weighted_mean():
    _, tp = _params()
    x = torch.tensor(_data(seed=4, n=10))
    got = tvae.eval_is_loglikelihood(tp, x, torch.Generator().manual_seed(2),
                                     Z_DIM, n_particles=7, batch_size=4)
    keys = tfit.draw_keys(torch.Generator().manual_seed(2), 3)
    with torch.no_grad():
        parts = [tvae.iw_log_likelihood(tp, x[i * 4:(i + 1) * 4], k, Z_DIM,
                                        7) * len(x[i * 4:(i + 1) * 4])
                 for i, k in enumerate(keys)]
    _close(got, float(sum(parts)) / 10, 1e-12)


@pytest.mark.parametrize("module", [tvae, tiwae])
def test_main_needs_the_card_unless_asked(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main([])


def test_vae_main_trains_on_the_cpu_when_asked(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))  # synthetic MNIST
    params = tvae.main(["--epochs", "1", "--n_test", "8", "--device",
                        "cpu"])
    out = capsys.readouterr().out
    assert "Epoch 1" in out and "TEST LOG LIKELIHOOD" in out
    assert params["decoder"][0]["w"].device.type == "cpu"
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
