"""Parity tests of zhusuan_tpu_torch's packaged training loop (``fit.py``:
``fit_scan``, ``make_fit_epoch``) against the JAX package's, on the CPU in
float64.

With a loss that draws nothing and ``shuffle=False``, both loops see the
same batches in the same order, so two epochs of Adam must leave the same
parameters (1e-8) and the same per-step loss history (1e-10), as the
SVGP test holds ``torch.optim.Adam`` to ``optax.adam``. The rest checks the
port's own contract: the dropped remainder, the callback, the optimizer
state carried across calls, the step generators and the errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
from zhusuan_tpu_torch import fit as tfit
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL_PARAMS = 1e-8
TOL_HISTORY = 1e-10
N, D, BATCH = 37, 5, 8  # 4 batches a epoch, a remainder of 5 dropped


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    return {"x": x, "y": np.tanh(x @ rng.randn(D)) + 0.1 * rng.randn(N)}


def _init():
    rng = np.random.RandomState(1)
    return {"w": [rng.randn(D, 3) * 0.5, rng.randn(3)], "b": np.zeros(())}


def _jax_loss(params, batch, key):
    del key
    h = jnp.tanh(batch["x"] @ params["w"][0])
    pred = h @ params["w"][1] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _torch_loss(params, batch, generator):
    del generator
    h = torch.tanh(batch["x"] @ params["w"][0])
    pred = h @ params["w"][1] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _torch_params():
    return jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                        _init())


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("lr", [1e-2, 0.3])
def test_two_epochs_of_adam_match_jax(lr):
    data = _data()
    jp, _, jhist = zs.fit_scan(
        _jax_loss, jax.tree.map(jnp.asarray, _init()), optax.adam(lr),
        jax.tree.map(jnp.asarray, data), key=jax.random.PRNGKey(0),
        epochs=2, batch_size=BATCH, shuffle=False)
    tp = _torch_params()
    opt = torch.optim.Adam(tree_leaves(tp), lr=lr)
    tp, state, thist = tfit.fit_scan(
        _torch_loss, tp, opt, jax.tree.map(torch.tensor, data),
        generator=torch.Generator().manual_seed(0), epochs=2,
        batch_size=BATCH, shuffle=False)
    assert thist.shape == jhist.shape == (2, N // BATCH)
    assert thist.dtype == np.float64
    _close(thist, jhist, TOL_HISTORY)
    jax.tree.map(lambda w, t: _close(t.detach().numpy(), w, TOL_PARAMS),
                 jp, tp)
    assert state["state"]  # Adam's moments, as a state_dict


def test_make_fit_epoch_matches_jax():
    data = _data()
    n_batches = N // BATCH
    jb = jax.tree.map(lambda a: jnp.asarray(a[:n_batches * BATCH]).reshape(
        (n_batches, BATCH) + a.shape[1:]), data)
    jopt = optax.adam(0.05)
    jparams = jax.tree.map(jnp.asarray, _init())
    jp, _, jlosses = zs.make_fit_epoch(_jax_loss, jopt)(
        jparams, jopt.init(jparams), jb, jax.random.PRNGKey(1))
    tp = _torch_params()
    opt = torch.optim.Adam(tree_leaves(tp), lr=0.05)
    tb = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jb)
    epoch_fn = tfit.make_fit_epoch(_torch_loss, opt)
    tp, state, tlosses = epoch_fn(tp, None, tb, torch.Generator())
    assert isinstance(tlosses, torch.Tensor) and tlosses.shape == (n_batches,)
    _close(tlosses.numpy(), jlosses, TOL_HISTORY)
    jax.tree.map(lambda w, t: _close(t.detach().numpy(), w, TOL_PARAMS),
                 jp, tp)


def test_optimizer_state_carries_across_calls():
    """Two one-epoch calls, the second from the first's ``opt_state``,
    equal one two-epoch call (also through a fresh optimizer)."""
    data = jax.tree.map(torch.tensor, _data())

    def run(splits):
        tp = _torch_params()
        state, hist = None, []
        for epochs in splits:
            opt = torch.optim.Adam(tree_leaves(tp), lr=0.1)
            tp, state, h = tfit.fit_scan(
                _torch_loss, tp, opt, data, generator=torch.Generator(),
                epochs=epochs, batch_size=BATCH, opt_state=state,
                shuffle=False)
            hist.append(h)
        return tp, np.concatenate(hist)

    (a, ha), (b, hb) = run([2]), run([1, 1])
    _close(ha, hb, 0)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("api", ["fit_scan", "make_fit_epoch"])
def test_opt_state_is_a_snapshot(api):
    """A kept ``opt_state`` is not moved by later training, in the
    optimizer or in a run resumed from it: resuming twice from an older
    ``opt_state`` gives the same run twice (JAX's optax state is
    immutable)."""
    data = jax.tree.map(torch.tensor, _data())
    n_batches = N // BATCH
    batches = jax.tree.map(lambda a: a[:n_batches * BATCH].reshape(
        (n_batches, BATCH) + a.shape[1:]), data)

    def epoch(tp, opt, state):
        if api == "fit_scan":
            tp, state, h = tfit.fit_scan(
                _torch_loss, tp, opt, data, generator=torch.Generator(),
                batch_size=BATCH, opt_state=state, shuffle=False)
            return tp, state, h[0]
        tp, state, h = tfit.make_fit_epoch(_torch_loss, opt)(
            tp, state, batches, torch.Generator())
        return tp, state, h.numpy()

    tp = _torch_params()
    opt = torch.optim.Adam(tree_leaves(tp), lr=0.1)
    tp, old, _ = epoch(tp, opt, None)
    start = [t.detach().clone() for t in tree_leaves(tp)]
    moments = [v.clone() for s in old["state"].values() for v in s.values()]
    epoch(tp, opt, None)  # more training on the live optimizer
    runs = []
    for _ in range(2):
        resumed = [t.clone().requires_grad_(True) for t in start]
        params = jax.tree.unflatten(jax.tree.structure(_init()), resumed)
        fresh = torch.optim.Adam(resumed, lr=0.1)
        runs.append(epoch(params, fresh, old))
        now = [v for s in old["state"].values() for v in s.values()]
        assert all(torch.equal(a, b) for a, b in zip(moments, now))
    (pa, _, ha), (pb, _, hb) = runs
    _close(ha, hb, 0)
    for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(x, y)


def test_shuffle_callback_and_generators():
    data = jax.tree.map(torch.tensor, _data())
    seen, seeds = [], []

    def loss(params, batch, generator):
        assert generator.device.type == "cpu"
        seeds.append(generator.initial_seed())
        seen.append(batch["x"][:, 0].clone())
        return _torch_loss(params, batch, generator)

    def run(seed, callback=None):
        seen.clear()
        seeds.clear()
        tp = _torch_params()
        opt = torch.optim.Adam(tree_leaves(tp), lr=0.1)
        _, _, hist = tfit.fit_scan(
            loss, tp, opt, data, generator=torch.Generator().manual_seed(seed),
            epochs=2, batch_size=BATCH, callback=callback)
        return hist, torch.cat(seen), list(seeds)

    calls = []
    hist, rows, step_seeds = run(5, lambda e, m: calls.append((e, m)))
    assert [e for e, _ in calls] == [0, 1]
    _close([m for _, m in calls], hist.mean(1), 1e-12)
    assert len(set(step_seeds)) == len(step_seeds) == 2 * (N // BATCH)
    # Each epoch takes 32 distinct rows of the 37, in a shuffled order.
    for epoch_rows in rows.reshape(2, -1):
        assert len(set(epoch_rows.tolist())) == 32
    assert not torch.equal(rows[:32], data["x"][:32, 0])
    again = run(5)
    _close(again[0], hist, 0)
    assert again[2] == step_seeds and torch.equal(again[1], rows)
    assert run(6)[2] != step_seeds


def test_draw_keys_is_reproducible():
    a = tfit.draw_keys(torch.Generator().manual_seed(3), 5)
    assert a == tfit.draw_keys(torch.Generator().manual_seed(3), 5)
    assert len(set(a)) == 5 and all(isinstance(k, int) for k in a)


def test_errors():
    data = jax.tree.map(torch.tensor, _data())
    tp = _torch_params()
    opt = torch.optim.Adam(tree_leaves(tp), lr=0.1)
    with pytest.raises(ValueError, match="exceeds the dataset size"):
        tfit.fit_scan(_torch_loss, tp, opt, data, generator=torch.Generator(),
                      batch_size=N + 1)
    with pytest.raises(TypeError, match="torch.Generator"):
        tfit.fit_scan(_torch_loss, tp, opt, data, generator=0)
