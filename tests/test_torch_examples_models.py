"""Parity tests of the port's Gaussian HMC toy, Bernoulli-latent VAE,
Gumbel-softmax VAE, convolutional VAE and variational dropout
(``zhusuan_tpu_torch/examples``) and of the conv helpers
(``examples/utils/nn.py``) against the JAX package's examples, on the CPU
in float64.

The JAX weights cross over through ``params_from_numpy`` (conv kernels
HWIO -> OIHW); each step's variational draws are rebuilt from the JAX key
(``fold_in(key, crc32(name))``: uniforms for a Bernoulli node,
open-interval uniforms for an ExpConcrete node, standard normals for a
Normal node) and fed through ``noise=``.

- each training example at a small width (x_dim 64, hidden 32; the conv
  VAE at its fixed 28x28 layout with z 4): the loss, its auxiliary outputs
  and the gradients of every parameter at 1e-10, five chained Adam steps
  at 1e-8;
- the conv and transposed-conv layers alone, at the VAE's shapes and at
  odd ones where "SAME" pads one side more: 1e-10;
- 30 iterations of ``gaussian.py``'s HMC recipe on both routes (the
  ``bn.normal`` model on the plain path; the built-in density with
  ``experimental_fused_step=True``, which takes the plain path on CPU
  tensors) against the JAX example's model, the momentum and MH draws fed
  in: 1e-8.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
from examples.bayesian_neural_nets import variational_dropout as jvd
from examples.utils import nn as jnn
from examples.variational_autoencoders import bernoulli_latent_vae as jblv
from examples.variational_autoencoders import gumbel_softmax_vae as jgs
from examples.variational_autoencoders import vae_conv as jconv
from zhusuan_tpu_torch.examples.bayesian_neural_nets import (
    variational_dropout as tvd,
)
from zhusuan_tpu_torch.examples.toy_examples import gaussian as tgauss
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.examples.variational_autoencoders import (
    bernoulli_latent_vae as tblv,
)
from zhusuan_tpu_torch.examples.variational_autoencoders import (
    gumbel_softmax_vae as tgs,
)
from zhusuan_tpu_torch.examples.variational_autoencoders import (
    vae_conv as tconv,
)
from zhusuan_tpu_torch.mcmc.hmc import state_from_numpy, state_to_numpy
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
TOL_CHAIN = 1e-8
TINY = float(np.finfo(np.float64).tiny)
X_DIM, HIDDEN, N = 64, 32, 6
N_STEPS = 5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _to_torch(jp):
    """The JAX parameters in float64 on both sides."""
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
    return jp, tnn.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _grads_close(params, jax_grads, tol=TOL):
    def one(want, leaf):
        assert leaf.grad is not None
        got = _np(leaf.grad)
        want = np.asarray(want)
        if want.ndim == 4:  # a conv kernel's gradient, HWIO
            want = want.transpose(3, 2, 0, 1)
        _close(got, want, tol)

    assert len(tree_leaves(params)) == len(jax.tree.leaves(jax_grads))
    jax.tree.map(one, jax_grads, params)


def _params_close(params, jax_params, tol):
    back = tnn.params_to_numpy(params)
    jax.tree.map(lambda w, t: _close(t, w, tol), jax_params, back)


def _data(seed, n=N, d=X_DIM):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, d) < 0.5).astype(np.float64)


def _node_key(key, name):
    return jax.random.fold_in(key, zlib.crc32(name.encode()))


def _uniform_noise(key, name, shape):
    return {name: torch.tensor(np.asarray(jax.random.uniform(
        _node_key(key, name), shape, jnp.float64)))}


def _open_uniform_noise(key, name, shape):
    return {name: torch.tensor(np.asarray(jax.random.uniform(
        _node_key(key, name), shape, jnp.float64, minval=TINY,
        maxval=1.0)))}


def _normal_noise(key, names_shapes):
    return {name: torch.tensor(np.asarray(jax.random.normal(
        _node_key(key, name), shape, jnp.float64)))
        for name, shape in names_shapes}


# --------------------------------------------------------------------- #
# The Bernoulli-latent VAE (REINFORCE with a baseline and moving mean)
# --------------------------------------------------------------------- #
BLV_Z = 8


def _blv_params():
    return _to_torch(jblv.init_params(jax.random.PRNGKey(5), X_DIM, BLV_Z,
                                      HIDDEN))


@pytest.mark.parametrize("n_particles", [1, 3])
def test_bernoulli_latent_vae_loss_and_gradients_match_jax(n_particles):
    jp, tp = _blv_params()
    x = _data(0)
    key = jax.random.PRNGKey(9)
    mm = 0.3
    (jloss, (jlb, jmm)), jgrads = jax.value_and_grad(
        jblv.loss_fn, has_aux=True)(jp, jnp.float64(mm), jnp.asarray(x),
                                    key, BLV_Z, n_particles)
    loss, (lb, new_mm) = tblv.loss_fn(
        tp, torch.tensor(mm, dtype=torch.float64), torch.tensor(x), 0,
        BLV_Z, n_particles,
        noise=_uniform_noise(key, "z", (n_particles, N, BLV_Z)))
    loss.backward()
    _close(loss, jloss)
    _close(lb, jlb)
    _close(new_mm, jmm)
    _grads_close(tp, jgrads)


def test_bernoulli_latent_vae_five_adam_steps_match_jax():
    jp, tp = _blv_params()
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jp)
    jmm = jnp.float64(0.0)
    tstep = tblv.make_train_step(torch.optim.Adam(tree_leaves(tp), lr=1e-3),
                                 BLV_Z)
    tmm = torch.zeros((), dtype=torch.float64)

    @jax.jit
    def jstep(p, s, mm, x, k):
        (_, (lb, new_mm)), g = jax.value_and_grad(
            jblv.loss_fn, has_aux=True)(p, mm, x, k, BLV_Z)
        u, s = jopt.update(g, s)
        return optax.apply_updates(p, u), s, new_mm, lb

    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(4),
                                             N_STEPS)):
        x = _data(10 + i)
        jp, jstate, jmm, jlb = jstep(jp, jstate, jmm, jnp.asarray(x), key)
        tmm, lb = tstep(tp, tmm, torch.tensor(x), i,
                        noise=_uniform_noise(key, "z", (1, N, BLV_Z)))
        assert not lb.requires_grad and not tmm.requires_grad
        _close(lb, jlb, TOL_CHAIN)
        _close(tmm, jmm, TOL_CHAIN)
    _params_close(tp, jp, TOL_CHAIN)


# --------------------------------------------------------------------- #
# The Gumbel-softmax (ExpConcrete) VAE
# --------------------------------------------------------------------- #
GS_VARS, GS_CLASSES = 4, 5


def _gs_params():
    return _to_torch(jgs.init_params(jax.random.PRNGKey(6), X_DIM, GS_VARS,
                                     GS_CLASSES, HIDDEN))


@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_gumbel_softmax_vae_loss_and_gradients_match_jax(tau):
    """One particle only: the example's ``group_ndims=2`` folds the batch
    axis into the latent's event (batch ``[n, n_vars]``, value
    ``[n_classes]``), so ``log p(z)`` and ``log q(z|x)`` have shape
    ``[n_particles]`` and meet ``log p(x|z)``'s ``[n_particles, n]`` only
    when ``n_particles`` is 1. The port keeps the JAX example's grouping."""
    n_particles = 1
    jp, tp = _gs_params()
    x = _data(1)
    key = jax.random.PRNGKey(11)
    (jloss, jlb), jgrads = jax.value_and_grad(jgs.loss_fn, has_aux=True)(
        jp, jnp.asarray(x), key, GS_VARS, GS_CLASSES, jnp.float64(tau),
        n_particles)
    loss, lb = tgs.loss_fn(
        tp, torch.tensor(x), 0, GS_VARS, GS_CLASSES,
        torch.tensor(tau, dtype=torch.float64), n_particles,
        noise=_open_uniform_noise(key, "z",
                                  (n_particles, N, GS_VARS, GS_CLASSES)))
    loss.backward()
    _close(loss, jloss)
    _close(lb, jlb)
    _grads_close(tp, jgrads)


def test_gumbel_softmax_vae_five_adam_steps_and_annealing_match_jax():
    jp, tp = _gs_params()
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jp)
    tstep = tgs.make_train_step(torch.optim.Adam(tree_leaves(tp), lr=1e-3),
                                GS_VARS, GS_CLASSES)

    @jax.jit
    def jstep(p, s, x, k, t):
        (_, lb), g = jax.value_and_grad(jgs.loss_fn, has_aux=True)(
            p, x, k, GS_VARS, GS_CLASSES, t)
        u, s = jopt.update(g, s)
        return optax.apply_updates(p, u), s, lb

    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(2),
                                             N_STEPS)):
        # the JAX example's schedule, over N_STEPS "epochs"
        tau = 1.0 - 0.5 * i / max(N_STEPS - 1, 1)
        assert float(tgs.temperature(i, N_STEPS)) == np.float32(tau)
        x = _data(20 + i)
        jp, jstate, jlb = jstep(jp, jstate, jnp.asarray(x), key,
                                jnp.float64(tau))
        lb = tstep(tp, torch.tensor(x), i,
                   torch.tensor(tau, dtype=torch.float64),
                   noise=_open_uniform_noise(key, "z",
                                             (1, N, GS_VARS, GS_CLASSES)))
        _close(lb, jlb, TOL_CHAIN)
    _params_close(tp, jp, TOL_CHAIN)


# --------------------------------------------------------------------- #
# The convolutional VAE and its layers
# --------------------------------------------------------------------- #
CONV_Z = 4


def _conv_params():
    return _to_torch(jconv.init_params(jax.random.PRNGKey(7), CONV_Z))


CONV_CASES = [  # (H, W, c_in, c_out, k, stride, padding)
    (28, 28, 1, 32, 4, 2, "SAME"), (14, 14, 32, 64, 4, 2, "SAME"),
    (7, 7, 64, 32, 4, 2, "SAME"), (9, 8, 3, 5, 3, 2, "SAME"),
    (10, 11, 2, 3, 5, 3, "SAME"), (9, 8, 3, 5, 3, 2, "VALID"),
    (6, 6, 2, 2, 2, 3, "SAME"), (5, 5, 2, 3, 3, 1, "SAME"),
]


@pytest.mark.parametrize("layer", ["conv_apply", "deconv_apply"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(
    str(v) for v in c))
def test_conv_layers_match_lax(case, layer):
    """``lax.conv_general_dilated`` / ``lax.conv_transpose`` (no kernel
    flip) with their "SAME"/"VALID" paddings, leading batch axes, value
    and input gradient."""
    h, w, c_in, c_out, k, stride, padding = case
    rng = np.random.RandomState(h * w + k)
    jp = {"w": jnp.asarray(rng.randn(k, k, c_in, c_out)),
          "b": jnp.asarray(rng.randn(c_out))}
    tp = tnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tuple(tp["w"].shape) == (c_out, c_in, k, k)
    x = rng.randn(2, 3, h, w, c_in)
    want, vjp = jax.vjp(lambda v: getattr(jnn, layer)(
        jp, v, stride=stride, padding=padding), jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = getattr(tnn, layer)(tp, tx, stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    _close(got, want)
    ct = rng.randn(*want.shape)
    got.backward(torch.tensor(ct))
    _close(tx.grad, vjp(jnp.asarray(ct))[0])


def test_conv_helpers_init_and_round_trip():
    g = torch.Generator().manual_seed(0)
    p = tnn.init_conv(g, 4, 4, 32, 64)
    assert tuple(p["w"].shape) == (64, 32, 4, 4) and p["w"].requires_grad
    np.testing.assert_allclose(float(p["w"].detach().std()),
                               np.sqrt(2.0 / (4 * 4 * 32)), rtol=0.05)
    jp = jconv.init_params(jax.random.PRNGKey(0), CONV_Z)
    tp = tconv.init_params(torch.Generator().manual_seed(0), CONV_Z)
    jax.tree.map(lambda a, t: np.testing.assert_array_equal(
        tuple(t.shape), a.shape if a.ndim != 4 else
        (a.shape[3], a.shape[2], a.shape[0], a.shape[1])), jp, tp)
    arrays = jax.tree.map(np.asarray, jp)
    back = tnn.params_to_numpy(tnn.params_from_numpy(arrays, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, arrays, back)
    with pytest.raises(ValueError, match="SAME"):
        tnn.conv_apply(tp["e_conv1"], torch.zeros(1, 28, 28, 1),
                       padding="FULL")


@pytest.mark.parametrize("n_particles", [1, 2])
def test_vae_conv_loss_and_gradients_match_jax(n_particles):
    jp, tp = _conv_params()
    x = _data(2, n=3, d=784)
    key = jax.random.PRNGKey(13)
    jloss, jgrads = jax.value_and_grad(jconv.elbo_loss)(
        jp, jnp.asarray(x), key, CONV_Z, n_particles)
    loss = tconv.elbo_loss(
        tp, torch.tensor(x), 0, CONV_Z, n_particles,
        noise=_normal_noise(key, [("z", (n_particles, 3, CONV_Z))]))
    loss.backward()
    _close(loss, jloss)
    _grads_close(tp, jgrads)


def test_vae_conv_five_adam_steps_match_jax():
    jp, tp = _conv_params()
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jp)
    tstep = tconv.make_train_step(torch.optim.Adam(tree_leaves(tp),
                                                   lr=1e-3), CONV_Z)

    @jax.jit
    def jstep(p, s, x, k):
        loss, g = jax.value_and_grad(jconv.elbo_loss)(p, x, k, CONV_Z)
        u, s = jopt.update(g, s)
        return optax.apply_updates(p, u), s, -loss

    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3),
                                             N_STEPS)):
        x = _data(30 + i, n=3, d=784)
        jp, jstate, jlb = jstep(jp, jstate, jnp.asarray(x), key)
        lb = tstep(tp, torch.tensor(x), i,
                   noise=_normal_noise(key, [("z", (1, 3, CONV_Z))]))
        _close(lb, jlb, TOL_CHAIN)
    _params_close(tp, jp, TOL_CHAIN)


# --------------------------------------------------------------------- #
# Variational dropout
# --------------------------------------------------------------------- #
VD_SIZE = [X_DIM, HIDDEN, HIDDEN, 10]
VD_N_TRAIN = 600


def _jvd_loss(params, x, y, key, n_particles):
    """The JAX example's ``loss_fn`` (defined inside its ``main``,
    variational_dropout.py:88-107), on its own ``var_dropout`` and
    ``build_q``."""
    n = x.shape[0]
    e_names = ["layer{}/eps".format(i) for i in range(len(VD_SIZE) - 1)]
    y_obs = jnp.tile(y[None], (n_particles, 1))
    model = jvd.var_dropout(params, x, n, VD_SIZE, n_particles)

    def log_joint(bn):
        return (sum(bn.cond_log_prob(e_names))
                + bn.cond_log_prob("y") * VD_N_TRAIN)

    model.log_joint = log_joint
    variational = jvd.build_q(params, n, VD_SIZE, n_particles, key)
    lower_bound = zs.variational.elbo(model, {"y": y_obs},
                                      variational=variational, axis=0)
    y_logit = lower_bound.bn["y_logit"]
    h_pred = jnp.mean(jax.nn.softmax(y_logit), 0)
    acc = jnp.mean((jnp.argmax(h_pred, -1) == y).astype(jnp.float64))
    return jnp.mean(lower_bound.sgvb()) / VD_N_TRAIN, acc


def _vd_noise(key, n_particles, n=N):
    return _normal_noise(key, [("layer{}/eps".format(i),
                                (n_particles, n, VD_SIZE[i]))
                               for i in range(len(VD_SIZE) - 1)])


def _vd_data(seed, n=N):
    rng = np.random.RandomState(seed)
    return rng.randn(n, X_DIM), rng.randint(0, 10, size=n).astype(np.int32)


def _vd_params():
    return _to_torch(jvd.init_params(jax.random.PRNGKey(8), VD_SIZE))


@pytest.mark.parametrize("n_particles", [1, 4])
def test_variational_dropout_loss_and_gradients_match_jax(n_particles):
    jp, tp = _vd_params()
    x, y = _vd_data(3)
    key = jax.random.PRNGKey(17)
    (jcost, jacc), jgrads = jax.value_and_grad(_jvd_loss, has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(y), key, n_particles)
    cost, acc = tvd.loss_fn(tp, torch.tensor(x), torch.tensor(y), 0,
                            VD_SIZE, VD_N_TRAIN, n_particles,
                            noise=_vd_noise(key, n_particles))
    cost.backward()
    _close(cost, jcost)
    _close(acc, jacc, 0)
    _grads_close(tp, jgrads)


def test_variational_dropout_five_adam_steps_match_jax():
    jp, tp = _vd_params()
    jopt = optax.adam(1e-3, eps=1e-4)
    jstate = jopt.init(jp)
    tstep = tvd.make_train_step(
        torch.optim.Adam(tree_leaves(tp), lr=1e-3, eps=1e-4), VD_SIZE,
        VD_N_TRAIN, n_particles=2)

    @jax.jit
    def jstep(p, s, x, y, k):
        (cost, acc), g = jax.value_and_grad(_jvd_loss, has_aux=True)(
            p, x, y, k, 2)
        u, s = jopt.update(g, s)
        return optax.apply_updates(p, u), s, cost

    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(5),
                                             N_STEPS)):
        x, y = _vd_data(40 + i)
        jp, jstate, jcost = jstep(jp, jstate, jnp.asarray(x),
                                  jnp.asarray(y), key)
        cost, _ = tstep(tp, torch.tensor(x), torch.tensor(y), i,
                        noise=_vd_noise(key, 2))
        _close(cost, jcost, TOL_CHAIN)
    _params_close(tp, jp, TOL_CHAIN)


# --------------------------------------------------------------------- #
# gaussian.py: 30 iterations of the HMC recipe on both routes
# --------------------------------------------------------------------- #
G_CHAINS, G_ITERS, G_ADAPT = 64, 30, 15


def _jax_gaussian_model():
    """The JAX example's model (gaussian.py:27-35), in float64."""
    stdev = jnp.asarray((1.0 / (np.arange(tgauss.N_X) + 1)).astype(
        np.float32), jnp.float64)

    @zs.meta_bayesian_net()
    def gaussian():
        bn = zs.BayesianNet()
        bn.normal("x", jnp.zeros([G_CHAINS, tgauss.N_X]), std=stdev,
                  group_ndims=1)
        return bn

    return gaussian()


@pytest.mark.parametrize("fused", [False, True], ids=["model", "builtin"])
def test_gaussian_recipe_matches_jax_example(fused):
    from zhusuan_tpu.mcmc.hmc import HMC as JHMC

    jhmc = JHMC(step_size=1e-3, n_leapfrogs=tgauss.N_LEAPFROGS,
                adapt_step_size=True, adapt_mass=True,
                target_acceptance_rate=0.9)
    jmodel = _jax_gaussian_model()
    jst = jhmc.init({"x": jnp.zeros([G_CHAINS, tgauss.N_X])},
                    n_chain_dims=1)
    thmc = tgauss.make_hmc(fused)
    assert thmc.experimental_fused_step is fused
    target = tgauss.log_joint(fused, G_CHAINS, dtype=torch.float64,
                              device="cpu")
    tst = tgauss.init_state(thmc, G_CHAINS, dtype=torch.float64,
                            device="cpu")
    np.testing.assert_array_equal(state_to_numpy(tst).q["x"],
                                  np.asarray(jst.q["x"]))
    step = jax.jit(lambda s, k, g: jhmc.sample(
        jmodel, {}, s, k, adapt_step_size=g, adapt_mass=g))
    for i in range(G_ITERS):
        key = jax.random.PRNGKey(100 + i)
        gate = i < G_ADAPT
        jst_new, info = step(jst, key, jnp.asarray(gate))
        # mcmc/hmc.py: p = normal(key_p) * sqrt(mass), u from key_u.
        eps = np.asarray(info.init_momentum["x"]) / np.sqrt(
            np.asarray(jst_new.mass["x"]))
        _, key_u, _ = jax.random.split(key, 3)
        u = np.asarray(jax.random.uniform(key_u, (G_CHAINS,), jnp.float64))
        tst, tinfo = thmc.sample(target, {}, tst, adapt_step_size=gate,
                                 adapt_mass=gate,
                                 noise=(torch.tensor(eps), torch.tensor(u)))
        _close(tinfo.acceptance_rate, info.acceptance_rate, TOL_CHAIN)
        jst = jst_new
    final = state_to_numpy(tst)
    for name in ("q", "step_size", "mass", "ewmv_var"):
        want = getattr(jst, name)
        want = ({k: np.asarray(v) for k, v in want.items()}
                if isinstance(want, dict) else np.asarray(want))
        jax.tree.map(lambda a, b: _close(a, b, TOL_CHAIN),
                     getattr(final, name), want)
    assert not np.allclose(final.mass["x"], 1.0)


def test_gaussian_example_runs_on_the_cpu():
    """The example's ``run`` at a reduced size on both routes: the pooled
    std within 0.2 of the target's (the JAX test's gate,
    ``tests/test_examples.py:24``)."""
    for fused in (False, True):
        _, out, rel_err = tgauss.run("cpu", fused, n_chains=200,
                                     n_iters=120, burnin=60)
        assert tuple(out["samples"]["x"].shape) == (60, 200, tgauss.N_X)
        assert float(rel_err.max()) < 0.2
    assert state_from_numpy is not None


# --------------------------------------------------------------------- #
# The harness's step builders of the four training examples
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["bernoulli_latent_vae",
                                  "gumbel_softmax_vae", "vae_conv",
                                  "variational_dropout"])
def test_acceptance_runs_the_examples_on_the_cpu(name, monkeypatch):
    """A few full-width steps of each example through its own step
    function, seeded: finite, reproducible; one epoch is the default. The
    test accuracy is taken on 200 rows here (2000 in the recipe)."""
    from zhusuan_tpu_torch.examples import acceptance

    monkeypatch.setattr(acceptance, "VDROP_TEST", 200)
    cpu = torch.device("cpu")
    out = acceptance.run(name, cpu, warmup=1, steps=3, tail=2)
    assert out["finite"] and out["timed_steps"] == 3
    assert np.isfinite(out["final_lb"]) and out["steps_per_sec"] > 0
    again = acceptance.run(name, cpu, warmup=1, steps=3, tail=2)
    assert again["final_lb"] == out["final_lb"]
    if name == "variational_dropout":
        assert 0.0 <= out["test_acc"] <= 1.0
    assert acceptance.epoch_steps(name) == {
        "bernoulli_latent_vae": 390, "gumbel_softmax_vae": 390,
        "vae_conv": 300, "variational_dropout": 60}[name]


# --------------------------------------------------------------------- #
# The examples' entry points: the card unless asked for the CPU
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("module", [tgauss, tblv, tgs, tconv, tvd],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_wants_the_card_unless_given_the_cpu(module):
    """``main()`` defaults to ``cuda:0`` and stops, without falling back
    to the CPU, when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main([])


def test_gaussian_main_runs_on_the_cpu(capsys):
    rel_err = tgauss.main(["--device", "cpu", "--fused"])
    assert float(rel_err.max()) < 0.2
    out = capsys.readouterr().out
    assert "Relative error of stdev:" in out and "Finished." in out
