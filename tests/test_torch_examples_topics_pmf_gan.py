"""Parity tests of the port's matrix factorization, topic-model and GAN
examples (``zhusuan_tpu_torch/examples/{probabilistic_matrix_factorization,
topic_models,generative_adversarial_nets}/``), their optimizers and data
(``examples/utils/{optimizers,utils,dataset}.py``) against the JAX
package, on the CPU in float64.

- ``pmf_hmc``: one alternating sweep (HMC over U, then V; the plain
  transition in both packages) from the JAX example's state on the JAX
  sweep's draws: 1e-8. The JAX example's ``sweep`` is taken from its
  ``main`` (its ``jax.jit`` replaced by a recorder), with its Normals'
  Python-float parameters as float64.
- ``lntm_mcem``: one E-step (five HMC iterations over ``eta`` with two
  chain axes, the dual-averaging state carried in) and one M-step (Adam on
  ``beta``) from the JAX example's ``main`` likewise, on its draws: 1e-8.
- ``dirichlet_vae.elbo_loss`` and its gradient with the posterior draws
  given (``theta=`` here; the JAX ``Dirichlet.sample`` made to return them):
  1e-10.
- ``dcgan.gan_losses``, ``wasserstein_gan.critic_loss`` / ``gen_loss`` and
  their gradients on the JAX generator's ``z`` (its uniforms through
  ``noise=``): 1e-10; three training steps of each GAN (Adam with ``b1 =
  0.5``; the port's copy of ``optax.rmsprop`` and the weight clip) against
  the JAX examples' steps: 1e-10.
- The port's ``adamax`` (``torch.optim.Adamax``, optax's rule) against
  ``optax.adamax`` over 20 steps and its ``RMSProp`` against
  ``optax.rmsprop`` (eps inside the square root, which
  ``torch.optim.RMSprop`` puts outside): 1e-12.
- The data fallbacks ``load_uci_bow``, ``load_movielens1m`` and
  ``load_cifar10`` equal to the JAX package's arrays (CIFAR's 60000 images
  through a ``RandomState`` whose draws of 50000 and 10000 rows are cut
  a hundredfold in both packages, to keep the test's memory small);
  ``save_image_collections`` writes the same PNG.
- Each example's ``main`` end to end on the CPU at the JAX tests'
  arguments, with their finiteness checks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
from examples.generative_adversarial_nets import dcgan as jdcgan
from examples.generative_adversarial_nets import wasserstein_gan as jwgan
from examples.probabilistic_matrix_factorization import pmf_hmc as jpmf
from examples.topic_models import dirichlet_vae as jdv
from examples.topic_models import lntm_mcem as jlntm
from examples.utils import dataset as jdataset
from examples.utils import utils as jutils
from zhusuan_tpu_torch.examples.generative_adversarial_nets import (
    dcgan as tdcgan,
)
from zhusuan_tpu_torch.examples.generative_adversarial_nets import (
    wasserstein_gan as twgan,
)
from zhusuan_tpu_torch.examples.probabilistic_matrix_factorization import (
    pmf_hmc as tpmf,
)
from zhusuan_tpu_torch.examples.topic_models import dirichlet_vae as tdv
from zhusuan_tpu_torch.examples.topic_models import lntm_mcem as tlntm
from zhusuan_tpu_torch.examples.utils import dataset as tdataset
from zhusuan_tpu_torch.examples.utils import optimizers as topt
from zhusuan_tpu_torch.examples.utils import utils as tutils
from zhusuan_tpu_torch.examples.utils.nn import (
    params_from_numpy,
    params_to_numpy,
)
from zhusuan_tpu_torch.mcmc.hmc import state_from_numpy
from zhusuan_tpu_torch.utils import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = 1e-10
TOL_CHAIN = 1e-8


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got).astype(np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _close_tree(params, want, grad=False):
    """A tree of the port's tensors (or their gradients) against the JAX
    tree, conv kernels taken back to HWIO."""
    got = params_to_numpy(tree_map(lambda p: p.grad if grad else p, params))
    jax.tree.map(lambda w, g: _close(g, w), want, got)


def _recorder():
    """A stand-in for ``jax.jit`` that keeps each function by name."""
    seen = {}

    def jit(f):
        seen[f.__name__] = f
        return f

    return seen, jit


def _jax_namespace(jit):
    return types.SimpleNamespace(jit=jit, nn=jax.nn, random=jax.random,
                                 tree=jax.tree,
                                 value_and_grad=jax.value_and_grad)


def _hmc_noise(key, q):
    """JAX ``HMC.sample(key)``'s draws for a one-latent dict: ``split(key,
    3) -> key_p, key_u, key_j``, the normals from ``split(key_p, 1)[0]``,
    the uniforms over the chain shape ``q``'s first axes."""
    (name, v), = q.items()
    key_p, key_u, _ = jax.random.split(key, 3)
    (kp,) = jax.random.split(key_p, 1)
    eps = torch.tensor(np.asarray(jax.random.normal(kp, v.shape,
                                                    jnp.float64)))
    return eps, key_u


# --------------------------------------------------------------------- #
# pmf_hmc
# --------------------------------------------------------------------- #
class _Float64Normal:
    """``zs.distributions.Normal`` with Python-float parameters as
    float64 (they would make float32 parameters, and ``log_prob`` then
    casts its input to float32)."""

    def __getattr__(self, name):
        return getattr(zs.distributions, name)

    @staticmethod
    def Normal(mean, std):
        f = (lambda v: jnp.float64(v) if isinstance(v, float) else v)
        return zs.distributions.Normal(f(mean), std=f(std))


def test_pmf_sweep_matches_jax(monkeypatch):
    seen, jit = _recorder()
    monkeypatch.setattr(jpmf, "jax", _jax_namespace(jit))
    monkeypatch.setattr(jpmf, "zs", types.SimpleNamespace(
        HMC=zs.HMC, distributions=_Float64Normal()))
    max_ratings = 3000
    jsu, jsv = jpmf.main(n_epochs=0, D=3, K=2, n_leapfrogs=4,
                         max_ratings=max_ratings)
    N, M, train, test, _ = tpmf.load_ratings(max_ratings)
    assert jsu.q["u"].shape == (2, N, 3) and jsv.q["v"].shape == (2, M, 3)
    sweep = jax.jit(seen["sweep"])
    key = jax.random.PRNGKey(21)
    jsu2, jsv2, jacc_u, jacc_v = sweep(jsu, jsv, key)
    k1, k2 = jax.random.split(key)
    eps_u, ku = _hmc_noise(k1, {"u": jsu.q["u"]})
    eps_v, kv = _hmc_noise(k2, {"v": jsv.q["v"]})
    noise = ((eps_u, torch.tensor(np.asarray(jax.random.uniform(
        ku, (2,), jnp.float64)))),
             (eps_v, torch.tensor(np.asarray(jax.random.uniform(
                 kv, (2,), jnp.float64)))))
    samplers = tpmf.make_samplers(n_leapfrogs=4)
    lj = tpmf.make_log_joints(*train, dtype=torch.float64, device="cpu")
    tsu = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsu))
    tsv = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsv))
    tsu2, tsv2, acc_u, acc_v = tpmf.sweep(samplers, lj, tsu, tsv,
                                          noise=noise)
    _close(acc_u, jacc_u, TOL_CHAIN)
    _close(acc_v, jacc_v, TOL_CHAIN)
    _close(tsu2.q["u"], jsu2.q["u"], TOL_CHAIN)
    _close(tsv2.q["v"], jsv2.q["v"], TOL_CHAIN)
    _close(tsu2.step_size, jsu2.step_size, TOL_CHAIN)
    _close(tpmf.eval_rmse(tsu2, tsv2, test),
           seen["eval_rmse"](jsu2, jsv2), TOL_CHAIN)


def test_pmf_main_runs():
    su, sv, rmse = tpmf.main(n_epochs=5, D=4, K=2, n_leapfrogs=3,
                             device="cpu", verbose=False)
    assert bool(torch.isfinite(su.q["u"]).all())
    assert len(rmse) == 1 and np.isfinite(rmse[0])


def test_pmf_synthetic_ratings_match_jax():
    for g, w in zip(tpmf.synthetic_ratings(n_obs=500),
                    jpmf.synthetic_ratings(n_obs=500)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --------------------------------------------------------------------- #
# lntm_mcem
# --------------------------------------------------------------------- #
class _Float64Jnp:
    """``jax.numpy`` whose ``float32`` is float64 (the JAX example fixes
    float32 in its model)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_lntm_e_step_and_m_step_match_jax(monkeypatch):
    seen, jit = _recorder()
    monkeypatch.setattr(jlntm, "jax", _jax_namespace(jit))
    monkeypatch.setattr(jlntm, "jnp", _Float64Jnp())
    bs, k = 20, 3
    jlntm.main(epochs=0, batch_size=bs, n_topics=k, run_ais=False)
    X, _, _ = tdataset.load_uci_bow("nips", n_docs=1500, n_vocab=500)
    x = X[:bs].astype(np.float64)
    v = x.shape[1]
    rng = np.random.RandomState(4)
    eta0 = 0.3 * rng.randn(1, bs, k)
    beta0 = 0.1 * rng.randn(k, v)
    eta_mean, eta_logstd = 0.2 * rng.randn(k), 0.1 * rng.randn(k)
    da = {"t": jnp.zeros((), jnp.int32), "step_size": jnp.float64(1e-3),
          "da_step": jnp.float64(0.0), "h_bar": jnp.float64(0.0),
          "log_epsilon_bar": jnp.float64(0.0)}
    key = jax.random.PRNGKey(8)
    jeta, jda, jacc = jax.jit(seen["e_step"])(
        jnp.asarray(eta0), jnp.asarray(beta0), jnp.asarray(eta_mean),
        jnp.asarray(eta_logstd), jnp.asarray(x), da, key)
    # JAX HMC.run: k, sub = split(k) an iteration.
    noise, kk = [], key
    for _ in range(5):
        kk, sub = jax.random.split(kk)
        eps, ku = _hmc_noise(sub, {"eta": eta0})
        noise.append((eps, torch.tensor(np.asarray(jax.random.uniform(
            ku, (1, bs), jnp.float64)))))
    t = dict(dtype=torch.float64)
    model = tlntm.make_model(1, bs, k, v, torch.tensor(eta_mean, **t),
                             torch.tensor(eta_logstd, **t))
    tda = tlntm.init_da_state(torch.float64)
    teta, tda2, tacc = tlntm.e_step(tlntm.make_sampler(), model,
                                    torch.tensor(eta0), torch.tensor(beta0),
                                    torch.tensor(x), tda, noise=noise)
    _close(teta, jeta, TOL_CHAIN)
    _close(tacc, jacc, TOL_CHAIN)
    assert tda2["t"] == int(jda["t"]) == 5
    for name in ("step_size", "da_step", "h_bar", "log_epsilon_bar"):
        _close(tda2[name], jda[name], TOL_CHAIN)
    # The M-step from the E-step's chains.
    opt = optax.adam(0.1)
    jbeta, _, jlj = jax.jit(seen["m_step"])(
        jnp.asarray(beta0), opt.init(jnp.asarray(beta0)), jeta,
        jnp.asarray(eta_mean), jnp.asarray(eta_logstd), jnp.asarray(x))
    beta = torch.tensor(beta0, requires_grad=True)
    tlj = tlntm.m_step(torch.optim.Adam([beta], lr=0.1), beta, model,
                       torch.tensor(np.asarray(jeta)), torch.tensor(x))
    _close(tlj, jlj, TOL_CHAIN)
    _close(beta, jbeta, TOL_CHAIN)


def test_lntm_main_runs():
    beta, eta_mean, eta_logstd, res = tlntm.main(
        epochs=2, batch_size=50, n_topics=5, ais_temperatures=40,
        device="cpu", verbose=False)
    assert bool(torch.isfinite(beta).all())
    assert np.isfinite(res["ll_lb"]) and res["perplexity_ub"] > 0
    assert tuple(eta_mean.shape) == tuple(eta_logstd.shape) == (5,)


# --------------------------------------------------------------------- #
# dirichlet_vae
# --------------------------------------------------------------------- #
def test_dirichlet_vae_elbo_and_gradient_match_jax(monkeypatch):
    params = _f64(jdv.init_params(jax.random.PRNGKey(3)))
    bows, _ = jdv.synthetic_corpus(n_docs=6, doc_len=20, seed=2)
    bows = bows.astype(np.float64)
    theta = np.random.RandomState(1).dirichlet(np.ones(jdv.N_TOPICS),
                                               size=(4, 6))

    class Given(jdv.Dirichlet):
        def sample(self, n_samples=None, key=None):
            return jnp.asarray(theta)

    monkeypatch.setattr(jdv, "Dirichlet", Given)
    want, gwant = jax.value_and_grad(jdv.elbo_loss)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(bows),
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(params, device="cpu")
    loss = tdv.elbo_loss(tparams, torch.tensor(bows),
                         theta=torch.tensor(theta))
    loss.backward()
    _close(loss, want)
    _close_tree(tparams, gwant, grad=True)


def test_dirichlet_vae_corpus_and_training():
    got, want = tdv.synthetic_corpus(n_docs=20, doc_len=16, seed=1), \
        jdv.synthetic_corpus(n_docs=20, doc_len=16, seed=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    hist, best = tdv.main(n_docs=64, epochs=3, batch_size=32, device="cpu",
                          verbose=False)
    assert hist.shape == (3, 2) and np.isfinite(hist).all()
    assert best.shape == (tdv.N_TOPICS,)
    params = tdv.init_params(torch.Generator().manual_seed(0))
    loss = tdv.elbo_loss(params, torch.tensor(got[0]),
                         torch.Generator().manual_seed(1))
    loss.backward()
    assert all(bool(torch.isfinite(p.grad).all())
               for p in tree_leaves(params))


# --------------------------------------------------------------------- #
# GANs
# --------------------------------------------------------------------- #
Z_DIM = 8


def _gan_params():
    kg, kd = jax.random.split(jax.random.PRNGKey(5))
    return (_f64(jdcgan.init_gen_params(kg, Z_DIM, ngf=4)),
            _f64(jdcgan.init_disc_params(kd, ndf=4)))


def _jax_z_noise(key, n):
    """The JAX generator's ``z`` at ``key`` as the port's uniform noise."""
    z = np.asarray(jdcgan.generator(
        jax.tree.map(jnp.asarray, _gan_params()[0]), n, Z_DIM, key)["z"]
        .tensor, np.float64)
    return {"z": torch.tensor((z + 1.0) / 2.0)}


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 32, 32, 3)


def test_gan_losses_and_gradients_match_jax():
    gp, dp = _gan_params()
    x = _images(3)
    key = jax.random.PRNGKey(9)
    noise = _jax_z_noise(key, 3)
    jg, jd = (jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp))
    (jgl, jdl) = jdcgan.gan_losses(jg, jd, jnp.asarray(x), key, Z_DIM)
    tg, td = (params_from_numpy(gp, device="cpu"),
              params_from_numpy(dp, device="cpu"))
    tgl, tdl = tdcgan.gan_losses(tg, td, torch.tensor(x), None, Z_DIM,
                                 noise=noise)
    _close(tgl, jgl)
    _close(tdl, jdl)
    gg = jax.grad(lambda p: jdcgan.gan_losses(p, jd, jnp.asarray(x), key,
                                              Z_DIM)[0])(jg)
    gd = jax.grad(lambda p: jdcgan.gan_losses(jg, p, jnp.asarray(x), key,
                                              Z_DIM)[1])(jd)
    for loss, params, want in ((tgl, tg, gg), (tdl, td, gd)):
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    retain_graph=True)
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g
        _close_tree(params, want, grad=True)
    # The WGAN losses on the same z.
    for jfn, tfn, first in ((jwgan.critic_loss, twgan.critic_loss, "d"),
                            (jwgan.gen_loss, twgan.gen_loss, "g")):
        jargs = (jd, jg) if first == "d" else (jg, jd)
        targs = (td, tg) if first == "d" else (tg, td)
        want, gwant = jax.value_and_grad(jfn)(*jargs, jnp.asarray(x), key,
                                              Z_DIM)
        got = tfn(*targs, torch.tensor(x), None, Z_DIM, noise=noise)
        _close(got, want)
        grads = torch.autograd.grad(got, tree_leaves(targs[0]))
        for p, g in zip(tree_leaves(targs[0]), grads):
            p.grad = g
        _close_tree(targs[0], gwant, grad=True)


def test_dcgan_three_steps_match_jax(monkeypatch):
    seen, jit = _recorder()
    monkeypatch.setattr(jdcgan, "jax", _jax_namespace(jit))
    lr = 1e-2
    jdcgan.main(epochs=0, batch_size=4, z_dim=Z_DIM, ngf=4, ndf=4, lr=lr,
                x_train=_images(8).astype(np.float32), save_samples=False)
    step = jax.jit(seen["train_step"])
    gp, dp = _gan_params()
    jg, jd = jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp)
    opt = optax.adam(lr, b1=0.5)
    gs, ds = opt.init(jg), opt.init(jd)
    tg, td = (params_from_numpy(gp, device="cpu"),
              params_from_numpy(dp, device="cpu"))
    tstep = tdcgan.make_train_step(tg, td, Z_DIM, lr)
    for i in range(3):
        x = _images(4, i)
        key = jax.random.PRNGKey(30 + i)
        noise = _jax_z_noise(key, 4)
        jg, jd, gs, ds, jgl, jdl = step(jg, jd, gs, ds, jnp.asarray(x), key)
        tgl, tdl = tstep(torch.tensor(x), noise=noise)
        _close(tgl, jgl)
        _close(tdl, jdl)
    _close_tree(tg, jg)
    _close_tree(td, jd)


def test_wgan_three_steps_match_jax(monkeypatch):
    seen, jit = _recorder()
    monkeypatch.setattr(jwgan, "jax", _jax_namespace(jit))
    lr, clip = 1e-3, 0.05
    jwgan.main(epochs=0, batch_size=4, z_dim=Z_DIM, n_critic=1, clip=clip,
               ngf=4, ndf=4, lr=lr, x_train=_images(8).astype(np.float32))
    critic_step = jax.jit(seen["critic_step"])
    gen_step = jax.jit(seen["gen_step"])
    gp, dp = _gan_params()
    jg, jd = jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp)
    opt = optax.rmsprop(lr)
    gs, ds = opt.init(jg), opt.init(jd)
    tg, td = (params_from_numpy(gp, device="cpu"),
              params_from_numpy(dp, device="cpu"))
    tcritic, tgen = twgan.make_steps(tg, td, Z_DIM, lr, clip)
    for i in range(3):
        x = jnp.asarray(_images(4, i))
        kc, kg = jax.random.PRNGKey(40 + i), jax.random.PRNGKey(50 + i)
        jd, ds, jcl = critic_step(jd, ds, jg, x, kc)
        jg, gs, jgl = gen_step(jg, gs, jd, x, kg)
        _close(tcritic(torch.tensor(np.asarray(x)),
                       noise=_jax_z_noise(kc, 4)), jcl)
        _close(tgen(torch.tensor(np.asarray(x)), noise=_jax_z_noise(kg, 4)),
               jgl)
    assert max(float(jnp.abs(w).max()) for w in jax.tree.leaves(jd)) \
        <= clip
    _close_tree(td, jd)
    _close_tree(tg, jg)


def test_gan_mains_run():
    data = (0.6 + 0.3 * _images(64)).astype(np.float32)
    gp, dp, hist = tdcgan.main(epochs=2, batch_size=16, z_dim=Z_DIM, ngf=4,
                               ndf=4, lr=1e-3, x_train=data,
                               iters_per_epoch=2, save_samples=False,
                               device="cpu", verbose=False)
    assert len(hist["gen_loss"]) == 2 and np.isfinite(
        hist["disc_loss"]).all()
    gp, dp, hist = twgan.main(epochs=2, batch_size=16, z_dim=Z_DIM,
                              n_critic=2, ngf=4, ndf=4, lr=1e-3,
                              x_train=data, iters_per_epoch=2, device="cpu",
                              verbose=False)
    assert np.isfinite(hist["w_dist"]).all()
    assert max(float(p.detach().abs().max()) for p in tree_leaves(dp)) <= 0.01
    np.testing.assert_array_equal(tdcgan.synthetic_cifar(20, 3),
                                  jdcgan.synthetic_cifar(20, 3))


# --------------------------------------------------------------------- #
# Optimizers, data, images
# --------------------------------------------------------------------- #
def _optax_run(opt, w, grads):
    state = opt.init(jnp.asarray(w))
    w = jnp.asarray(w)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, upd)
    return np.asarray(w)


def _torch_run(make, w, grads):
    p = torch.tensor(w, requires_grad=True)
    opt = make([p])
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    return p.detach().numpy()


def test_adamax_matches_optax_over_20_steps():
    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 3)
    grads = [rng.randn(5, 3) * (0.1 + i % 4) for i in range(20)]
    grads[3][1, 1] = 0.0
    want = _optax_run(optax.adamax(0.05, b1=0.8, b2=0.99, eps=1e-3), w0,
                      grads)
    got = _torch_run(lambda p: topt.adamax(p, 0.05, b1=0.8, b2=0.99,
                                           eps=1e-3), w0, grads)
    _close(got, want, 1e-12)
    _close(_torch_run(lambda p: topt.AdamaxOptimizer(p), w0, grads),
           _optax_run(optax.adamax(1e-3), w0, grads), 1e-12)
    assert isinstance(topt.adamax([torch.zeros(1, requires_grad=True)]),
                      torch.optim.Adamax)


def test_rmsprop_matches_optax():
    rng = np.random.RandomState(1)
    w0 = rng.randn(4, 2)
    grads = [rng.randn(4, 2) * 1e-3 for _ in range(10)]
    want = _optax_run(optax.rmsprop(0.01), w0, grads)
    _close(_torch_run(lambda p: topt.RMSProp(p, lr=0.01), w0, grads), want,
           1e-12)
    other = _torch_run(lambda p: torch.optim.RMSprop(p, lr=0.01, alpha=0.9,
                                                     eps=1e-8), w0, grads)
    assert np.abs(other - want).max() > 1e-6


def test_bow_and_movielens_fallbacks_equal_jax():
    for got, want in ((tdataset.load_uci_bow("nips", n_docs=1500,
                                             n_vocab=500),
                       jdataset.load_uci_bow("nips", n_docs=1500,
                                             n_vocab=500)),
                      (tdataset.load_movielens1m(),
                       jdataset.load_movielens1m())):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, tuple):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


class _SmallRandomState(np.random.RandomState):
    """A ``RandomState`` whose draws of 50000 or 10000 rows are cut to a
    hundredth (the CIFAR fallback's sizes)."""

    @staticmethod
    def _cut(n):
        return n // 100 if n in (50000, 10000) else n

    def rand(self, *shape):
        return super().rand(*((self._cut(shape[0]),) + shape[1:])
                            if shape else ())

    def randint(self, low, high=None, size=None, dtype=int):
        return super().randint(low, high, self._cut(size) if isinstance(
            size, int) else size, dtype)


def test_cifar_fallback_equals_jax(monkeypatch):
    monkeypatch.setattr(np.random, "RandomState", _SmallRandomState)
    for one_hot in (True, False):
        got = tdataset.load_cifar10(one_hot=one_hot)
        want = jdataset.load_cifar10(one_hot=one_hot)
        assert got[0].shape == (500, 32, 32, 3) and got[4] and want[4]
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)


def test_save_image_collections_matches_jax(tmp_path):
    x = np.random.RandomState(2).rand(7, 6, 5, 3)
    tutils.save_image_collections(torch.tensor(x), str(tmp_path / "t" /
                                                      "a.png"), shape=(3, 3))
    jutils.save_image_collections(x, str(tmp_path / "j" / "a.png"),
                                  shape=(3, 3))
    assert (tmp_path / "t" / "a.png").read_bytes() == \
        (tmp_path / "j" / "a.png").read_bytes()
    g = (np.random.RandomState(3).rand(4, 5, 5, 1) * 255).astype(np.uint8)
    tutils.save_image_collections(g, str(tmp_path / "g.png"), shape=(2, 2),
                                  scale_each=True)
    jutils.save_image_collections(g, str(tmp_path / "h.png"), shape=(2, 2),
                                  scale_each=True)
    assert (tmp_path / "g.png").read_bytes() == \
        (tmp_path / "h.png").read_bytes()


def test_conf_data_dir_matches_jax(monkeypatch, tmp_path):
    from examples import conf as jconf
    from zhusuan_tpu_torch.examples import conf as tconf

    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))
    assert tconf.data_dir() == jconf.data_dir() == str(tmp_path)
    monkeypatch.delenv("ZS_DATA_DIR")
    assert tconf.data_dir() == jconf.data_dir()
