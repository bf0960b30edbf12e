"""Parity tests of zhusuan_tpu_torch's importance-weighted objective
(``variational/monte_carlo.py``: IWAE ``sgvb``, ``dreg``, ``vimco``) and
of ``evaluation.is_loglikelihood`` against the JAX package, on the CPU in
float64.

Both sides run the examples' nets at a small size (x_dim 16, hidden 8,
z 4, k 5): the VAE (``examples/variational_autoencoders/vae.py``) and the
sigmoid belief net (``examples/sigmoid_belief_nets/sbn.py``). The JAX
weights cross over through ``params_from_numpy``; the JAX package's draws
of the variational nodes (normals for the VAE's ``z``, uniforms for the
SBN's three Bernoulli layers) are rebuilt from ``fold_in(key,
crc32(name))`` and fed to the port through ``noise=``. Surrogate values
and gradients with respect to every parameter hold to 1e-10, the IS
estimate to 1e-12.
"""

import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from examples.sigmoid_belief_nets import sbn as jsbn
from examples.utils import nn as jnn
from examples.variational_autoencoders import vae as jvae
from zhusuan_tpu_torch import evaluation as tevaluation
from zhusuan_tpu_torch import variational as tvariational
from zhusuan_tpu_torch.examples.sigmoid_belief_nets import sbn as tsbn
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.examples.variational_autoencoders import vae as tvae
from zhusuan_tpu_torch.framework import BayesianNet
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
TOL_IS = 1e-12
X_DIM, HIDDEN, Z_DIM, N, K = 16, 8, 4, 6, 5
KEY = jax.random.PRNGKey(11)


def _close(got, want, tol=TOL):
    got, want = (v.detach().numpy() if isinstance(v, torch.Tensor) else v
                 for v in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _grads_close(params, jax_grads, tol=TOL):
    """Each port leaf's ``.grad`` against the JAX gradient of the same
    name (the trees are matched by key, not by order)."""
    def one(want, leaf):
        assert leaf.grad is not None and leaf.grad.shape == want.shape
        _close(leaf.grad, want, tol)

    assert len(tree_leaves(params)) == len(jax.tree.leaves(jax_grads))
    jax.tree.map(one, jax_grads, params)


def _node_draw(key, name, shape, kind):
    k = jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))
    draw = jax.random.normal if kind == "normal" else jax.random.uniform
    return np.asarray(draw(k, shape, jnp.float64))


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(N, X_DIM) < 0.5).astype(np.float64)


def _params(net):
    key = jax.random.PRNGKey(3)
    if net == "vae":
        p = jvae.init_params(key, X_DIM, Z_DIM, HIDDEN)
    else:
        p = jsbn.init_sbn_params(key, X_DIM, HIDDEN)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
    return jp, tnn.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _noise(net, key):
    if net == "vae":
        return {"z": torch.tensor(_node_draw(key, "z", (K, N, Z_DIM),
                                             "normal"))}
    return {"h1": torch.tensor(_node_draw(key, "h1", (K, N, HIDDEN), "u")),
            "h2": torch.tensor(_node_draw(key, "h2", (1, K, N, HIDDEN),
                                          "u")[0]),
            "h3": torch.tensor(_node_draw(key, "h3", (1, K, N, HIDDEN),
                                          "u")[0])}


def _jax_q_path(params, x, key):
    """The JAX VAE's q(z|x) with ``use_path_derivative=True`` (DReG)."""
    bn = zs.BayesianNet(key=key)
    h = jnn.mlp_apply(params["encoder"], x, final_activation=jax.nn.relu)
    bn.normal("z", jnn.mlp_apply([params["z_mean"]], h),
              logstd=jnn.mlp_apply([params["z_logstd"]], h), group_ndims=1,
              n_samples=K, use_path_derivative=True)
    return bn


def _torch_q_path(params, x, noise):
    bn = BayesianNet(key=0, noise=noise)
    h = tnn.mlp_apply(params["encoder"], x, final_activation=torch.relu)
    bn.normal("z", tnn.mlp_apply([params["z_mean"]], h),
              logstd=tnn.mlp_apply([params["z_logstd"]], h), group_ndims=1,
              n_samples=K, use_path_derivative=True)
    return bn


def _jax_objective(net, params, x, key, path=False):
    if net == "vae":
        q = (_jax_q_path(params, x, key) if path
             else jvae.build_q(params, x, Z_DIM, K, key))
        model = jvae.build_gen(params, X_DIM, Z_DIM, N, K)
    else:
        q = jsbn.build_q_net(params, x, HIDDEN, K, key)
        model = jsbn.build_sbn(params, N, X_DIM, HIDDEN, K)
    return zs.variational.importance_weighted_objective(
        model, {"x": x}, variational=q, axis=0)


def _torch_objective(net, params, x, noise, path=False):
    if net == "vae":
        q = (_torch_q_path(params, x, noise) if path
             else tvae.build_q(params, x, Z_DIM, K, 0, noise=noise))
        model = tvae.build_gen(params, X_DIM, Z_DIM, N, K)
    else:
        q = tsbn.build_q_net(params, x, HIDDEN, K, 0, noise=noise)
        model = tsbn.build_sbn(params, N, X_DIM, HIDDEN, K)
    return tvariational.importance_weighted_objective(
        model, {"x": x}, variational=q, axis=0)


def _estimator(obj, name):
    return getattr(obj, name)()


CASES = [("vae", "sgvb"), ("vae", "dreg"), ("vae", "vimco"),
         ("sbn", "sgvb"), ("sbn", "vimco")]


@pytest.mark.parametrize("net,estimator", CASES)
def test_surrogate_and_gradients_match_jax(net, estimator):
    x = _data()
    jp, tp = _params(net)
    path = estimator == "dreg"

    def jax_loss(p):
        obj = _jax_objective(net, p, jnp.asarray(x), KEY, path)
        return jnp.mean(_estimator(obj, estimator)), jnp.mean(obj.tensor)

    (jloss, jbound), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jp)
    obj = _torch_objective(net, tp, torch.tensor(x), _noise(net, KEY), path)
    loss = torch.mean(_estimator(obj, estimator))
    loss.backward()
    _close(loss, jloss)
    _close(torch.mean(obj.tensor), jbound)
    if estimator in ("sgvb", "dreg"):
        _close(loss, -jbound)  # both surrogates' value is the bound's
    _grads_close(tp, jgrads)


@pytest.mark.parametrize("net", ["vae", "sbn"])
def test_is_loglikelihood_matches_jax(net):
    x = _data()
    jp, tp = _params(net)
    if net == "vae":
        jq = jvae.build_q(jp, jnp.asarray(x), Z_DIM, K, KEY)
        jm = jvae.build_gen(jp, X_DIM, Z_DIM, N, K)
        tq = tvae.build_q(tp, torch.tensor(x), Z_DIM, K, 0,
                          noise=_noise(net, KEY))
        tm = tvae.build_gen(tp, X_DIM, Z_DIM, N, K)
    else:
        jq = jsbn.build_q_net(jp, jnp.asarray(x), HIDDEN, K, KEY)
        jm = jsbn.build_sbn(jp, N, X_DIM, HIDDEN, K)
        tq = tsbn.build_q_net(tp, torch.tensor(x), HIDDEN, K, 0,
                              noise=_noise(net, KEY))
        tm = tsbn.build_sbn(tp, N, X_DIM, HIDDEN, K)
    want = zs.evaluation.is_loglikelihood(jm, {"x": jnp.asarray(x)},
                                          proposal=jq, axis=0)
    got = tevaluation.is_loglikelihood(tm, {"x": torch.tensor(x)},
                                       proposal=tq, axis=0)
    assert got.shape == (N,)
    _close(got, want, TOL_IS)


def test_vae_iw_log_likelihood_matches_jax():
    x = _data()
    jp, tp = _params("vae")
    want = jvae.iw_log_likelihood(jp, jnp.asarray(x), KEY, Z_DIM, K)
    got = tvae.iw_log_likelihood(tp, torch.tensor(x), 0, Z_DIM, K,
                                 noise=_noise("vae", KEY))
    _close(got, want, TOL_IS)


def test_latent_pairs_match_the_variational_net():
    """``latent={name: (samples, log_probs)}`` gives the same bound and
    VIMCO cost as ``variational=`` (reference monte_carlo.py:74-85)."""
    x = torch.tensor(_data())
    _, tp = _params("sbn")
    noise = _noise("sbn", KEY)
    q = tsbn.build_q_net(tp, x, HIDDEN, K, 0, noise=noise)
    model = tsbn.build_sbn(tp, N, X_DIM, HIDDEN, K)
    latent = {k: q.query(k, outputs=True, local_log_prob=True)
              for k in ("h1", "h2", "h3")}
    a = tvariational.iw_objective(model, {"x": x}, latent=latent, axis=0)
    b = _torch_objective("sbn", tp, x, noise)
    _close(a.tensor, b.tensor, 0)
    _close(a.vimco(), b.vimco(), 0)


def test_checks_match_jax():
    x = _data()
    jp, tp = _params("vae")
    jq = jvae.build_q(jp, jnp.asarray(x), Z_DIM, 1, KEY)
    tq = tvae.build_q(tp, torch.tensor(x), Z_DIM, 1, 0,
                      noise={"z": torch.zeros(1, N, Z_DIM,
                                              dtype=torch.float64)})
    jm = jvae.build_gen(jp, X_DIM, Z_DIM, N, 1)
    tm = tvae.build_gen(tp, X_DIM, Z_DIM, N, 1)
    for lib, m, q, xx in ((zs.variational, jm, jq, jnp.asarray(x)),
                          (tvariational, tm, tq, torch.tensor(x))):
        with pytest.raises(ValueError, match="`axis` argument must be"):
            lib.importance_weighted_objective(m, {"x": xx}, variational=q)
        obj = lib.iw_objective(m, {"x": xx}, variational=q, axis=0)
        with pytest.raises(ValueError, match="larger than 1"):
            obj.vimco()
        with pytest.raises(ValueError, match="use_path_derivative=True"):
            obj.dreg()
    # Not reparameterized (the SBN's Bernoulli layers).
    jsp, tsp = _params("sbn")
    with pytest.raises(ValueError, match="reparameterized variational"):
        _jax_objective("sbn", jsp, jnp.asarray(x), KEY).dreg()
    with pytest.raises(ValueError, match="reparameterized variational"):
        _torch_objective("sbn", tsp, torch.tensor(x),
                         _noise("sbn", KEY)).dreg()


def test_dreg_from_latent_pairs_warns_as_jax():
    x = torch.tensor(_data())
    _, tp = _params("vae")
    q = _torch_q_path(tp, x, _noise("vae", KEY))
    model = tvae.build_gen(tp, X_DIM, Z_DIM, N, K)
    latent = {"z": q.query("z", outputs=True, local_log_prob=True)}
    obj = tvariational.iw_objective(model, {"x": x}, latent=latent, axis=0)
    with pytest.warns(UserWarning, match="cannot verify that the score"):
        cost = obj.dreg()
    ref = _torch_objective("vae", tp, x, _noise("vae", KEY), path=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _close(cost, ref.dreg(), 0)
