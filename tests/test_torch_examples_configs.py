"""Parity tests of the port's toy2d and BNN acceptance examples
(``zhusuan_tpu_torch/examples/toy_examples/toy2d_intractable.py``,
``bayesian_neural_nets/{bnn_vi,bnn_sgmcmc}.py``) against the JAX package's,
on the CPU in float64, and of the port's copies of the measured recipes and
their data (``examples/utils/{protocols,dataset}.py``) against
``baseline_ref/`` and ``examples/utils/dataset.py``, bit for bit.

The JAX package's draws are rebuilt from its keys and fed through
``noise=``: the guides' normals from ``fold_in(key, crc32(name))``, SGHMC's
from ``split(key) -> key_r, key_n`` and ``tree_normal_like``. The toy2d
model's scalar parameters are float32 weak types in the JAX example; the
``jax_float64_scalars`` fixture passes them as float64 (the port takes a
``dtype``). Losses hold to 1e-10, as does one SGHMC step.
"""

import json
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
from baseline_ref import configs_protocol as jproto
from baseline_ref import vae_protocol as jvae_proto
from examples.bayesian_neural_nets import bnn_sgmcmc as jsgmcmc
from examples.bayesian_neural_nets import bnn_vi as jbnn
from examples.toy_examples import toy2d_intractable as jtoy
from examples.utils import dataset as jdataset
from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu_torch.examples.bayesian_neural_nets import (
    bnn_sgmcmc as tsgmcmc,
)
from zhusuan_tpu_torch.examples.bayesian_neural_nets import bnn_vi as tbnn
from zhusuan_tpu_torch.examples.toy_examples import toy2d_intractable as ttoy
from zhusuan_tpu_torch.examples.utils import dataset as tdataset
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.examples.utils import protocols
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol=TOL):
    got, want = (v.detach().numpy() if isinstance(v, torch.Tensor) else v
                 for v in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _normal(key, name, shape):
    k = jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))
    return torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float64)))


@pytest.fixture
def jax_float64_scalars(monkeypatch):
    """``BayesianNet.normal`` of the JAX package with Python-float
    parameters passed as float64 (they are float32 weak types there)."""
    original = zs.BayesianNet.normal

    def cast(v):
        return jnp.float64(v) if isinstance(v, float) else v

    def normal(self, name, mean=0.0, *args, **kwargs):
        kwargs = {k: cast(v) if k in ("std", "logstd") else v
                  for k, v in kwargs.items()}
        return original(self, name, cast(mean), *args, **kwargs)

    monkeypatch.setattr(zs.BayesianNet, "normal", normal)


# --------------------------------------------------------------------- #
# toy2d
# --------------------------------------------------------------------- #
TOY_P = 7
TOY_START = {"z1_mean": 0.3, "z1_logstd": -0.7, "z2_mean": -0.4,
             "z2_logstd": -1.1}


def test_toy2d_loss_and_gradients_match_jax(jax_float64_scalars):
    key = jax.random.PRNGKey(3)
    jparams = {k: jnp.float64(v) for k, v in TOY_START.items()}
    jmodel = jtoy.build_toy2d_intractable(TOY_P)

    def jax_loss(params):
        q = jtoy.build_mean_field_variational(params, TOY_P, key)
        lb = zs.variational.elbo(jmodel, {}, variational=q, axis=0)
        return lb.sgvb(), lb.tensor

    (jcost, jlb), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jparams)
    tparams = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
               for k, v in TOY_START.items()}
    tmodel = ttoy.build_toy2d_intractable(TOY_P, dtype=torch.float64,
                                          device=CPU)
    noise = {n: _normal(key, n, (TOY_P,)) for n in ("z1", "z2")}
    cost, lb = ttoy.loss_fn(tmodel, tparams, TOY_P, 0, noise=noise)
    cost.backward()
    _close(cost, jcost)
    _close(lb, jlb)
    for k in TOY_START:
        _close(tparams[k].grad, jgrads[k])


def test_toy2d_train_steps_and_defaults():
    params = ttoy.init_params(device=CPU)
    assert {k: v.item() for k, v in params.items()} == {
        "z1_mean": -2.0, "z1_logstd": -5.0, "z2_mean": -2.0,
        "z2_logstd": -5.0}
    assert all(v.dtype == torch.float32 and v.requires_grad
               for v in params.values())
    model = ttoy.build_toy2d_intractable(50, device=CPU)
    opt = torch.optim.Adam([params[k] for k in ttoy.PARAM_NAMES], lr=0.1)
    step = ttoy.make_train_step(model, opt, 50)
    lbs = torch.stack([step(params, k) for k in range(30)])
    assert torch.isfinite(lbs).all() and not lbs.requires_grad
    assert float(lbs[-10:].mean()) > float(lbs[:10].mean())


# --------------------------------------------------------------------- #
# BNN with SGVB
# --------------------------------------------------------------------- #
LAYERS = [5, 7, 1]
BNN_P, BNN_BATCH, BNN_N_TRAIN = 3, 10, 50


def _bnn_data(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(BNN_BATCH, LAYERS[0]), rng.randn(BNN_BATCH)


def _bnn_params():
    rng = np.random.RandomState(4)
    shapes = [(n_out, n_in + 1) for n_in, n_out in zip(LAYERS[:-1],
                                                       LAYERS[1:])]
    arrays = {"w_means": [rng.randn(*s) * 0.5 for s in shapes],
              "w_logstds": [rng.randn(*s) * 0.3 - 1.0 for s in shapes],
              "y_logstd": np.asarray(-0.3)}
    return (jax.tree.map(jnp.asarray, arrays),
            tnn.params_from_numpy(arrays, device=CPU))


def _bnn_noise(key, n_particles):
    return {"w" + str(i): _normal(key, "w" + str(i),
                                  (n_particles, n_out, n_in + 1))
            for i, (n_in, n_out) in enumerate(zip(LAYERS[:-1], LAYERS[1:]))}


def test_bnn_sgvb_loss_and_gradients_match_jax():
    x, y = _bnn_data()
    jp, tp = _bnn_params()
    key = jax.random.PRNGKey(5)
    jloss, jgrads = jax.value_and_grad(
        jbnn.make_loss(LAYERS, BNN_N_TRAIN, BNN_P))(
        jp, jnp.asarray(x), jnp.asarray(y), key)
    loss = tbnn.make_loss(LAYERS, BNN_N_TRAIN, BNN_P)(
        tp, torch.tensor(x), torch.tensor(y), 0,
        noise=_bnn_noise(key, BNN_P))
    loss.backward()
    _close(loss, jloss)
    assert len(tree_leaves(tp)) == len(jax.tree.leaves(jgrads))
    jax.tree.map(lambda w, t: _close(t.grad, w), jgrads, tp)


def test_bnn_sgvb_train_steps_and_predict_match_jax():
    import optax

    jp, tp = _bnn_params()
    jopt = optax.adam(0.01)
    jstate = jopt.init(jp)
    jloss = jbnn.make_loss(LAYERS, BNN_N_TRAIN, BNN_P)
    topt = torch.optim.Adam(tree_leaves(tp), lr=0.01)
    tstep = tbnn.make_train_step(tbnn.make_loss(LAYERS, BNN_N_TRAIN, BNN_P),
                                 topt)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(6), 5)):
        x, y = _bnn_data(seed=30 + i)
        loss, grads = jax.value_and_grad(jloss)(jp, jnp.asarray(x),
                                                jnp.asarray(y), key)
        updates, jstate = jopt.update(grads, jstate)
        jp = optax.apply_updates(jp, updates)
        lb = tstep(tp, torch.tensor(x), torch.tensor(y), i,
                   noise=_bnn_noise(key, BNN_P))
        _close(lb, -loss, 1e-8)
    jax.tree.map(lambda w, t: _close(t, w, 1e-8), jp, tp)
    x, y = _bnn_data(seed=99)
    key = jax.random.PRNGKey(7)
    want = jbnn.predict(jp, jnp.asarray(x), jnp.asarray(y), LAYERS, 4, key,
                        2.5)
    got = tbnn.predict(tp, torch.tensor(x), torch.tensor(y), LAYERS, 4, 0,
                       2.5, noise=_bnn_noise(key, 4))
    _close(got[0], want[0], 1e-8)
    _close(got[1], want[1], 1e-8)


def test_bnn_init_params():
    p = tbnn.init_params([13, 50, 1], device=CPU)
    assert [tuple(w.shape) for w in p["w_means"]] == [(50, 14), (1, 51)]
    assert all(t.detach().abs().max().item() == 0.0 and t.requires_grad
               for t in tree_leaves(p))


# --------------------------------------------------------------------- #
# BNN with SGHMC and EM
# --------------------------------------------------------------------- #
SG_LAYERS = [4, 6, 1]
SG_P, SG_BATCH, SG_N_TRAIN = 5, 12, 100


def _jax_sghmc_model(x, logstds):
    """The model of ``bnn_sgmcmc.py:main`` (make_model)."""
    names = ["w0", "w1"]
    model = jsgmcmc.build_bnn(x, SG_LAYERS, logstds, SG_P)

    def log_joint(bn):
        log_pws = bn.cond_log_prob(names)
        return sum(log_pws) + jnp.mean(bn.cond_log_prob("y"), 1) * \
            SG_N_TRAIN

    model.log_joint = log_joint
    return model


def _torch_tree(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("lr", [2e-6, 1e-3])
def test_bnn_sghmc_steps_match_jax(lr):
    rng = np.random.RandomState(8)
    w = {"w" + str(i): rng.uniform(size=(SG_P, n_out, n_in + 1)) * 4 - 2
         for i, (n_in, n_out) in enumerate(zip(SG_LAYERS[:-1],
                                               SG_LAYERS[1:]))}
    logstds = [rng.randn(n_out, n_in + 1) * 0.2
               for n_in, n_out in zip(SG_LAYERS[:-1], SG_LAYERS[1:])]
    jsampler = zs.SGHMC(learning_rate=lr, friction=0.2,
                        n_iter_resample_v=1000, second_order=True)
    tsampler = tsgmcmc.make_sampler(lr=lr)
    k_init = jax.random.PRNGKey(9)
    jstate = jsampler.init(jax.tree.map(jnp.asarray, w), key=k_init)
    v0 = jbase.tree_normal_like(k_init, jstate.q)
    tstate = tsampler.init(_torch_tree(w), noise=_torch_tree(v0))
    for t, key in enumerate(jax.random.split(jax.random.PRNGKey(10), 2)):
        x, y = rng.randn(SG_BATCH, SG_LAYERS[0]), rng.randn(SG_BATCH)
        model = _jax_sghmc_model(jnp.asarray(x),
                                 [jnp.asarray(s) for s in logstds])
        jstate, jinfo = jsampler.sample(model, {"y": jnp.asarray(y)},
                                        jstate, key)
        key_r, key_n = jax.random.split(key)
        eps = _torch_tree(jbase.tree_normal_like(key_n, jstate.q))
        eps_v = (_torch_tree(jbase.tree_normal_like(key_r, jstate.q))
                 if t == 0 else None)
        tstate, mean_k = tsgmcmc.e_step(
            tsampler, tstate, [torch.tensor(s) for s in logstds],
            torch.tensor(x), torch.tensor(y), SG_LAYERS, SG_P, SG_N_TRAIN,
            None, noise=(eps, eps_v))
        for name in w:
            _close(tstate.q[name], jstate.q[name])
            _close(tstate.v[name], jstate.v[name])
            _close(mean_k[name], jinfo.mean_k[name])
    got = tsgmcmc.m_step(tstate, SG_LAYERS)
    want = [0.5 * jnp.log(jnp.mean(jstate.q[n] ** 2, axis=0))
            for n in ("w0", "w1")]
    for g, v in zip(got, want):
        _close(g, v)
    x = rng.randn(SG_BATCH, SG_LAYERS[0])
    jbn = jsgmcmc.build_bnn(jnp.asarray(x), SG_LAYERS,
                            [jnp.asarray(v) for v in want], SG_P).observe(
        **jstate.q)
    _close(tsgmcmc.predict(tstate, got, torch.tensor(x), SG_LAYERS, SG_P),
           jnp.mean(jbn["y_mean"], 0))


def test_bnn_sghmc_init_weights():
    w = tsgmcmc.init_weights(torch.Generator().manual_seed(0), [9, 50, 1],
                             20)
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        "w0": (20, 50, 10), "w1": (20, 1, 51)}
    assert all(float(v.min()) >= -2 and float(v.max()) < 2
               for v in w.values())


# --------------------------------------------------------------------- #
# The recipes and the data, copied
# --------------------------------------------------------------------- #
def test_protocol_recipes_are_the_baseline_refs():
    for name in ("TOY2D", "BNN_SGVB", "BNN_SGHMC", "SBN_VIMCO", "SVGP"):
        assert getattr(protocols, name) == getattr(jproto, name), name
    assert protocols.VAE_N_TRAIN == jvae_proto.N_TRAIN
    assert protocols.VAE_BATCH == jvae_proto.BATCH
    assert protocols.VAE_EPOCHS == jvae_proto.EPOCHS
    assert protocols.VAE_Z_DIM == jvae_proto.Z_DIM
    assert protocols.VAE_LR == jvae_proto.LR
    assert protocols.VAE_SHUFFLE_SEED == jvae_proto.SHUFFLE_SEED


@pytest.mark.parametrize("n_train,batch,steps", [(45, 10, 13), (456, 100, 9),
                                                 (7, 3, 5)])
def test_minibatch_indices_are_the_baseline_refs(n_train, batch, steps):
    np.testing.assert_array_equal(
        protocols.minibatch_indices(n_train, batch, steps),
        jproto.minibatch_indices(n_train, batch, steps))


def test_synthetic_binary_mnist_is_the_baseline_refs():
    got = protocols.synthetic_binary_mnist(48, 1234)
    want = jproto.synthetic_binary_mnist(48, 1234)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_vae_protocol_data_is_the_baseline_refs():
    got = protocols.vae_train_data()
    want = jvae_proto.load_train()
    assert got.shape == want.shape == (10000, 784)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(protocols.vae_permutations(), jvae_proto.permutations()):
        np.testing.assert_array_equal(a, b)


def test_mnist_loaders_are_the_examples(monkeypatch, tmp_path):
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))
    got = tdataset.load_mnist_realval()
    want = jdataset.load_mnist_realval()
    assert got[-1] is want[-1] is True  # synthetic: no files here
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = tdataset.load_binary_mnist(seed=3)
    want = jdataset.load_binary_mnist(seed=3)
    assert got[-1] is want[-1] is True
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# The runners of the measured recipes, and the scripts around them
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["toy2d", "bnn_sgvb", "bnn_sghmc",
                                  "sbn_vimco", "iwae"])
def test_acceptance_runs_on_the_cpu(name):
    from zhusuan_tpu_torch.examples import acceptance

    out = acceptance.run(name, CPU, warmup=2, steps=6, tail=3)
    assert out["warmup_steps"] == 2 and out["timed_steps"] == 6
    assert out["finite"] and out["steps_per_sec"] > 0
    metric = "final_mean_k" if name == "bnn_sghmc" else "final_lb"
    assert np.isfinite(out[metric])
    if name == "bnn_sghmc":
        assert np.isfinite(out["test_rmse_standardized"])
    again = acceptance.run(name, CPU, warmup=2, steps=6, tail=3)
    assert again[metric] == out[metric]  # seeded, on the CPU


def test_acceptance_defaults_are_the_recipes():
    from zhusuan_tpu_torch.examples import acceptance

    assert acceptance.RECIPES == {"toy2d": protocols.TOY2D,
                                  "bnn_sgvb": protocols.BNN_SGVB,
                                  "bnn_sghmc": protocols.BNN_SGHMC,
                                  "sbn_vimco": protocols.SBN_VIMCO}


def test_vae_protocol_runs_on_the_cpu():
    from zhusuan_tpu_torch.examples import acceptance

    seen = []
    params, out = acceptance.run_vae_protocol(
        CPU, epochs=1, callback=lambda e, lb, s: seen.append((e, lb)))
    assert seen == [(1, out["elbo_curve"][0])]
    assert out["steps_per_epoch"] == 78 and out["finite"]
    assert params["decoder"][2]["w"].shape == (500, 784)


def _imports(path):
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("script", ["measure_configs_torch.py",
                                    "profile_vae_sbn.py"])
def test_scripts_import_no_jax(script):
    names = _imports(os.path.join(ROOT, "scripts", script))
    assert any(n.startswith("zhusuan_tpu_torch") for n in names)
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "optax", "zhusuan_tpu", "examples", "baseline_ref")]


def test_measure_script_checks_its_arguments():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "measure_configs_torch.py"), "bogus"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and "unknown configurations" in out.stderr


def test_measured_configs_are_stamped():
    """Every entry of ``scripts/torch_configs.json`` names the commit it
    was measured at and the card with its power limit, and covers the
    full recipe."""
    with open(os.path.join(ROOT, "scripts", "torch_configs.json")) as f:
        results = json.load(f)
    assert set(results) == {"toy2d", "bnn_sgvb", "bnn_sghmc", "sbn_vimco",
                            "svgp", "vae_protocol", "svgp_diabetes"}
    for name, entry in results.items():
        assert entry["commit"] and "H100" in entry["card"], name
        assert entry["card"].strip().endswith("W"), name
    for name, cfg in (("toy2d", protocols.TOY2D),
                      ("bnn_sgvb", protocols.BNN_SGVB),
                      ("bnn_sghmc", protocols.BNN_SGHMC),
                      ("sbn_vimco", protocols.SBN_VIMCO),
                      ("svgp", protocols.SVGP)):
        assert results[name]["timed_steps"] == cfg["timed_steps"], name
        assert results[name]["warmup_steps"] == cfg["warmup_steps"], name
    assert len(results["vae_protocol"]["elbo_curve"]) == \
        protocols.VAE_EPOCHS
    assert results["svgp_diabetes"]["epochs"] == 2000


def test_diabetes_from_a_saved_file_is_sklearns(monkeypatch, tmp_path):
    """``save_uci_diabetes`` writes scikit-learn's arrays; the loader reads
    them from ``ZS_DATA_DIR`` (a host without scikit-learn) and gives the
    JAX example's splits bit for bit."""
    pytest.importorskip("sklearn")
    tdataset.save_uci_diabetes(str(tmp_path / "diabetes.npz"))
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))
    got = tdataset.load_uci_diabetes()
    want = jdataset.load_uci_diabetes()
    assert got[-1] is False
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("module,argv", [
    (ttoy, ["--n_iters", "3", "--n_particles", "5"]),
    (tbnn, ["--epochs", "1"]),
    (tsgmcmc, ["--epochs", "1"]),
])
def test_mains_run_on_the_cpu_only_when_asked(module, argv, monkeypatch,
                                              tmp_path, capsys):
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))  # synthetic data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main(argv)
    out = module.main(argv + ["--device", "cpu"])
    leaves = tree_leaves(out)
    assert leaves and all(torch.isfinite(t).all() for t in leaves
                          if isinstance(t, torch.Tensor))
    if module is ttoy:
        assert "Final variational params" in capsys.readouterr().out
