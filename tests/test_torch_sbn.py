"""Parity tests of the port's sigmoid belief net examples
(``zhusuan_tpu_torch/examples/sigmoid_belief_nets``: ``sbn.py``,
``sbn_vimco.py``) against the JAX package's, on the CPU in float64 at a
small size (x_dim 16, h_dim 8, k 4).

The three Bernoulli layers of the inference net draw uniforms; each step's
are rebuilt from the JAX key (``fold_in(key, crc32(name))``) and fed
through ``noise=``. The VIMCO loss and its gradients hold to 1e-10; five
chained Adam(1e-3, eps=1e-4) steps to 1e-8, the JAX side being the train
step of ``examples/sigmoid_belief_nets/sbn_vimco.py:main``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.sigmoid_belief_nets import sbn as jsbn
from examples.sigmoid_belief_nets import sbn_vimco as jvimco
from zhusuan_tpu_torch.examples.sigmoid_belief_nets import sbn as tsbn
from zhusuan_tpu_torch.examples.sigmoid_belief_nets import sbn_vimco
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
TOL_CHAIN = 1e-8
X_DIM, H_DIM, N, K = 16, 8, 6, 4
N_STEPS = 5


def _close(got, want, tol=TOL):
    got, want = (v.detach().numpy() if isinstance(v, torch.Tensor) else v
                 for v in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _uniforms(key, n_particles=K, n=N):
    def u(name, shape):
        k = jax.random.fold_in(key, zlib.crc32(name.encode("utf-8")))
        return torch.tensor(np.asarray(jax.random.uniform(k, shape,
                                                          jnp.float64)))

    return {"h1": u("h1", (n_particles, n, H_DIM)),
            "h2": u("h2", (1, n_particles, n, H_DIM))[0],
            "h3": u("h3", (1, n_particles, n, H_DIM))[0]}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(N, X_DIM) < 0.5).astype(np.float64)


def _params():
    p = jsbn.init_sbn_params(jax.random.PRNGKey(2), X_DIM, H_DIM)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
    return jp, tnn.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def test_nets_match_jax():
    """The inference net's samples and log-probs, and the generative net's
    log-joint at them."""
    x = _data()
    jp, tp = _params()
    key = jax.random.PRNGKey(8)
    jq = jsbn.build_q_net(jp, jnp.asarray(x), H_DIM, K, key)
    tq = tsbn.build_q_net(tp, torch.tensor(x), H_DIM, K, 0,
                          noise=_uniforms(key))
    names = ["h1", "h2", "h3"]
    for name in names:
        _close(tq.outputs(name), jq.outputs(name), 0)
        _close(tq.cond_log_prob(name), jq.cond_log_prob(name))
    obs = {n: jq.outputs(n) for n in names}
    jm = jsbn.build_sbn(jp, N, X_DIM, H_DIM, K).observe(
        x=jnp.asarray(x), **obs)
    tm = tsbn.build_sbn(tp, N, X_DIM, H_DIM, K).observe(
        x=torch.tensor(x), **{n: tq.outputs(n) for n in names})
    _close(tm.log_joint(), jm.log_joint())


def test_vimco_loss_and_gradients_match_jax():
    x = _data()
    jp, tp = _params()
    key = jax.random.PRNGKey(6)
    (jcost, jlb), jgrads = jax.value_and_grad(jvimco.vimco_loss,
                                              has_aux=True)(
        jp, jnp.asarray(x), key, H_DIM, K)
    cost, lb = sbn_vimco.vimco_loss(tp, torch.tensor(x), 0, H_DIM, K,
                                    noise=_uniforms(key))
    cost.backward()
    _close(cost, jcost)
    _close(lb, jlb)
    assert len(tree_leaves(tp)) == len(jax.tree.leaves(jgrads))
    jax.tree.map(lambda w, t: _close(t.grad, w), jgrads, tp)


def test_five_vimco_steps_match_jax():
    jp, tp = _params()
    jopt = optax.adam(1e-3, eps=1e-4)
    jstate = jopt.init(jp)

    @jax.jit
    def jstep(params, opt_state, x, key):
        (_, lb), grads = jax.value_and_grad(jvimco.vimco_loss,
                                            has_aux=True)(
            params, x, key, H_DIM, K)
        updates, opt_state = jopt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, lb

    topt = torch.optim.Adam(tree_leaves(tp), lr=1e-3, eps=1e-4)
    tstep = sbn_vimco.make_train_step(topt, H_DIM, K)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(1),
                                             N_STEPS)):
        x = _data(seed=20 + i)
        jp, jstate, jlb = jstep(jp, jstate, jnp.asarray(x), key)
        lb = tstep(tp, torch.tensor(x), i, noise=_uniforms(key))
        _close(lb, jlb, TOL_CHAIN)
    jax.tree.map(lambda w, t: _close(t, w, TOL_CHAIN), jp, tp)


def test_eval_is_loglikelihood_matches_its_bound():
    """The IS estimate of the SBN is the importance-weighted bound's value
    (no gradient kept)."""
    x = torch.tensor(_data())
    _, tp = _params()
    got = sbn_vimco.eval_is_loglikelihood(tp, x, 5, H_DIM, n_particles=7)
    _, lb = sbn_vimco.vimco_loss(tp, x, 5, H_DIM, 7)
    assert not got.requires_grad
    _close(got, lb, 1e-12)


def test_float32_params_draw_from_their_generators():
    g = torch.Generator().manual_seed(0)
    params = tsbn.init_sbn_params(g, X_DIM, H_DIM)
    x = torch.tensor(_data(), dtype=torch.float32)
    q = tsbn.build_q_net(params, x, H_DIM, K, 3)
    h1 = q.outputs("h1")
    assert h1.dtype == torch.float32 and h1.shape == (K, N, H_DIM)
    assert set(torch.unique(h1).tolist()) <= {0.0, 1.0}
    again = tsbn.build_q_net(params, x, H_DIM, K, 3).outputs("h1")
    assert torch.equal(h1, again)


def test_main_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        sbn_vimco.main([])


def test_main_trains_on_the_cpu_when_asked(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))  # synthetic MNIST
    params = sbn_vimco.main(["--epochs", "1", "--h_dim", "16", "--device",
                             "cpu"])
    assert "Epoch 1" in capsys.readouterr().out
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
