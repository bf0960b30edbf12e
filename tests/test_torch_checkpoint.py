"""The port's checkpoints (``zhusuan_tpu_torch/checkpoint.py``): the JAX
package's tests of ``zhusuan_tpu/checkpoint.py`` translated, and the
cross-package contract: for the same state both packages write the same
file (equal ``__paths__``, ``__exotic__`` and ``__step__``, byte-equal
leaves), and a file written by either restores in the other.

The JAX side writes with ``use_orbax=False`` (the npz format the port
shares; the JAX package prefers orbax when it is installed).
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu.checkpoint import restore_checkpoint as jax_restore
from zhusuan_tpu.checkpoint import save_checkpoint as jax_save
from zhusuan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _npz_entries(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _assert_same_file(a, b):
    """Two npz checkpoints hold the same paths, exotic dtypes, step and
    byte-equal leaves."""
    ea, eb = _npz_entries(a), _npz_entries(b)
    assert sorted(ea) == sorted(eb)
    assert ea["__paths__"].tobytes() == eb["__paths__"].tobytes(), (
        ea["__paths__"].tobytes(), eb["__paths__"].tobytes())
    assert ea["__exotic__"].tobytes() == eb["__exotic__"].tobytes()
    assert ea["__step__"].dtype == eb["__step__"].dtype
    for k in ea:
        assert ea[k].dtype == eb[k].dtype, k
        assert ea[k].shape == eb[k].shape, k
        assert ea[k].tobytes() == eb[k].tobytes(), k


def _jax_leaf_to_torch(x):
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(x))


def _lj(obs):
    return jnp.sum(-0.5 * obs["x"] ** 2, -1)


def _port_lj(obs):
    return torch.sum(-0.5 * obs["x"] ** 2, -1)


def _jax_states():
    """(name, JAX state, port template of the same structure)."""
    hmc = zs.HMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True)
    h = hmc.init({"x": jnp.zeros((4, 2))}, log_joint=_lj)
    h, _ = hmc.sample(_lj, {}, h, jax.random.PRNGKey(0))
    h_t = zt.HMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True).init(
        {"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)

    mala = zs.MALA(step_size=0.3, adapt_step_size=True)
    m = mala.init({"x": jnp.zeros((4, 2))}, n_chain_dims=1)
    m, _ = mala.sample(_lj, {}, m, jax.random.PRNGKey(0))
    m_t = zt.MALA(step_size=0.3, adapt_step_size=True).init(
        {"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)

    rwm = zs.RandomWalkMetropolis(step_size=0.3)
    r = rwm.init({"x": jnp.zeros((4, 2))}, n_chain_dims=1)
    r, _ = rwm.sample(_lj, {}, r, jax.random.PRNGKey(3))
    r_t = zt.RandomWalkMetropolis(step_size=0.3).init(
        {"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)

    svgd = zs.variational.SVGD(learning_rate=0.1)
    s = svgd.init({"x": jnp.ones((5, 2))})
    s, _ = svgd.update(_lj, {}, s)
    s_t = zt.variational.SVGD(learning_rate=0.1).init(
        {"x": torch.ones(5, 2, dtype=F64)})

    ess = zs.mcmc.EllipticalSlice(prior_std=1.0)
    e = ess.init({"x": jnp.zeros((4, 2))}, n_chain_dims=1)
    e, _ = ess.sample(_lj, {}, e, jax.random.PRNGKey(1))
    e_t = zt.mcmc.EllipticalSlice(prior_std=1.0).init(
        {"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)

    nested = {"b": [jnp.ones(2), {"c": jnp.arange(3)}],
              "a": (jnp.float64(2.5), [jnp.zeros((1, 2), jnp.int32)]),
              "w": jnp.linspace(-2, 2, 6).reshape(2, 3).astype(jnp.bfloat16)}
    nested_t = {"b": [torch.ones(2), {"c": torch.arange(3)}],
                "a": (torch.tensor(0.0), [torch.zeros(1, 2)]),
                "w": torch.zeros(2, 3, dtype=torch.bfloat16)}
    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}
    params_t = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    return [("hmc", h, h_t), ("mala", m, m_t), ("rwm", r, r_t),
            ("svgd", s, s_t), ("ess", e, e_t), ("nested", nested, nested_t),
            ("params", params, params_t)]


@pytest.mark.parametrize("case", range(7), ids=[
    "hmc", "mala", "rwm", "svgd", "ess", "nested", "params"])
def test_same_state_same_file_both_directions(tmp_path, case):
    name, state, template = _jax_states()[case]
    jax_file = jax_save(str(tmp_path / "jax"), state, step=7,
                        use_orbax=False)
    # JAX -> port: the leaves restore into the port's own state type.
    restored, step = restore_checkpoint(jax_file, like=template)
    assert step == 7
    assert type(restored) is type(template)
    jax_leaves = jax.tree.leaves(state)
    port_leaves = [x for _, x, _ in zt.checkpoint._flatten(restored)]
    assert len(port_leaves) == len(jax_leaves)
    for j, t in zip(jax_leaves, port_leaves):
        if isinstance(t, torch.Tensor):
            want = _jax_leaf_to_torch(j)
            assert t.dtype == want.dtype and torch.equal(t, want)
        else:  # a sampler's host-int counter
            assert isinstance(t, int) and t == int(j)
    # port -> file: the same file JAX wrote.
    port_file = save_checkpoint(str(tmp_path / "port.npz"), restored,
                                step=7)
    _assert_same_file(jax_file, port_file)
    # port file -> JAX.
    back, step = jax_restore(port_file, like=state)
    assert step == 7
    for a, b in zip(jax.tree.leaves(back), jax_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def test_port_state_writes_jax_file(tmp_path):
    """A state made by the port alone (its host-int ``t`` included) gives
    the file the JAX package writes for the same arrays."""
    hmc = zt.HMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True)
    st = hmc.init({"x": torch.linspace(-1, 1, 8, dtype=F64).reshape(4, 2)},
                  n_chain_dims=1)
    st, _ = hmc.sample(_port_lj, {}, st, (1, 2))
    st, _ = hmc.sample(_port_lj, {}, st, (1, 2))
    assert st.t == 2
    port_file = save_checkpoint(str(tmp_path / "p"), st, step=2)
    js = zs.HMCState(*[
        jax.tree.map(lambda v: jnp.asarray(v.numpy()), f)
        if not isinstance(f, int) else jnp.asarray(f, jnp.int32)
        for f in st])
    jax_file = jax_save(str(tmp_path / "j"), js, step=2, use_orbax=False)
    _assert_same_file(jax_file, port_file)


def test_committed_jax_reference_is_current(tmp_path):
    """``scripts/checkpoint_jax_reference.npz`` equals what its script
    writes now, and restores into the port's HMCState."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "checkpoint_jax_reference",
        os.path.join(REPO, "scripts", "checkpoint_jax_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.write(str(tmp_path / "fresh.npz"))
    committed = os.path.join(REPO, "scripts", "checkpoint_jax_reference.npz")
    _assert_same_file(committed, fresh)

    like = {"hmc": zt.HMC(step_size=0.3, adapt_step_size=True,
                          adapt_mass=True).init(
        {"x": torch.zeros(4, 3)}, n_chain_dims=1),
        "bf16": torch.zeros(2, 3, dtype=torch.bfloat16)}
    tree, step = restore_checkpoint(committed, like=like)
    assert step == mod.STEPS
    assert isinstance(tree["hmc"], zt.HMCState)
    assert tree["hmc"].t == mod.STEPS and isinstance(tree["hmc"].t, int)
    assert tree["bf16"].dtype == torch.bfloat16
    assert torch.equal(tree["bf16"].float(),
                       torch.arange(6.0).reshape(2, 3) / 2)
    want = mod.reference_tree()["hmc"]
    np.testing.assert_array_equal(tree["hmc"].q["x"].numpy(),
                                  np.asarray(want.q["x"]))
    np.testing.assert_array_equal(tree["hmc"].mass["x"].numpy(),
                                  np.asarray(want.mass["x"]))


def test_resume_is_bit_exact(tmp_path):
    """k iterations, save, restore with ``like=``, continue: the run equals
    the uninterrupted one bit for bit (the counter ``t`` round-trips)."""
    hmc = zt.HMC(step_size=0.3, n_leapfrogs=4, adapt_step_size=True,
                 adapt_mass=True)
    s0 = hmc.init({"x": torch.zeros(8, 3, dtype=F64)}, n_chain_dims=1)
    key = (11, 12)
    full, _ = hmc.run(_port_lj, {}, s0, key, 10, n_adapt=6, collect=False)
    half, _ = hmc.run(_port_lj, {}, s0, key, 4, n_adapt=6, collect=False)
    p = save_checkpoint(str(tmp_path / "h"), half, step=4)
    restored, step = restore_checkpoint(p, like=s0)
    assert step == 4 and restored.t == 4
    rest, _ = hmc.run(_port_lj, {}, restored, key, 6, n_adapt=6,
                      collect=False)
    assert torch.equal(rest.q["x"], full.q["x"])
    assert torch.equal(rest.step_size, full.step_size)
    assert torch.equal(rest.mass["x"], full.mass["x"])


# --------------------------------------------------------------------- #
# tests/test_checkpoint.py, translated
# --------------------------------------------------------------------- #
def test_checkpoint_roundtrip_params(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    p = save_checkpoint(str(tmp_path / "ckpt"), params, step=7)
    assert p.endswith(".npz")
    restored, step = restore_checkpoint(p, device="cpu")
    assert step == 7
    assert torch.equal(restored["w"], params["w"])


def test_checkpoint_roundtrip_hmc_state_and_resume(tmp_path):
    hmc = zt.HMC(step_size=0.3, n_leapfrogs=3, adapt_step_size=True)
    state = hmc.init({"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)
    state, _ = hmc.sample(_port_lj, {}, state, (0, 0))
    p = save_checkpoint(str(tmp_path / "hmc"), state, step=1)
    restored, step = restore_checkpoint(p, like=state)
    assert isinstance(restored, zt.HMCState)
    assert torch.equal(restored.q["x"], state.q["x"])
    state2, _ = hmc.sample(_port_lj, {}, restored, (0, 1))
    assert torch.isfinite(state2.q["x"]).all()


def test_checkpoint_empty_dict_roundtrip(tmp_path):
    p = save_checkpoint(str(tmp_path / "e"), {})
    restored, _ = restore_checkpoint(p, device="cpu")
    assert restored == {}


def test_checkpoint_none_entries_need_like(tmp_path):
    state = {"a": torch.ones(2), "b": None}
    p = save_checkpoint(str(tmp_path / "n"), state)
    bare, _ = restore_checkpoint(p, device="cpu")
    assert "b" not in bare
    withlike, _ = restore_checkpoint(p, like=state)
    assert withlike["b"] is None
    assert torch.equal(withlike["a"], torch.ones(2))


def test_checkpoint_list_with_none_requires_like(tmp_path):
    state = {"a": [torch.tensor(1.0), None, torch.tensor(2.0)]}
    p = save_checkpoint(str(tmp_path / "holes.npz"), state)
    with pytest.raises(ValueError, match="like"):
        restore_checkpoint(p, device="cpu")
    restored, _ = restore_checkpoint(p, like=state)
    assert restored["a"][1] is None
    assert float(restored["a"][2]) == 2.0


def test_checkpoint_legacy_format_clear_error(tmp_path):
    p = str(tmp_path / "old.npz")
    np.savez(p, __treedef__=np.frombuffer(pickle.dumps((1, 2)),
                                          dtype=np.uint8),
             __step__=np.asarray(0), leaf_0=np.ones(3))
    with pytest.raises(ValueError, match="old pickled-treedef"):
        restore_checkpoint(p, device="cpu")


def test_checkpoint_untrusted_file_cannot_execute_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    p = str(tmp_path / "evil.npz")
    np.savez(p, __paths__=np.asarray([Evil()], dtype=object),
             __step__=np.asarray(0))
    with pytest.raises(ValueError):
        restore_checkpoint(p, device="cpu")


def test_checkpoint_roundtrip_new_sampler_states(tmp_path):
    mala = zt.MALA(step_size=0.3, adapt_step_size=True)
    m = mala.init({"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)
    m, _ = mala.sample(_port_lj, {}, m, (0, 0))
    s = zt.variational.SVGD(learning_rate=0.1)
    sv = s.init({"x": torch.ones(5, 2, dtype=F64)})
    sv, _ = s.update(_port_lj, {}, sv)
    ess = zt.mcmc.EllipticalSlice(prior_std=1.0)
    e = ess.init({"x": torch.zeros(4, 2, dtype=F64)}, n_chain_dims=1)
    e, _ = ess.sample(_port_lj, {}, e, torch.Generator().manual_seed(1))
    for name, state in (("mala", m), ("svgd", sv), ("ess", e)):
        p = save_checkpoint(str(tmp_path / name), state, step=1)
        restored, step = restore_checkpoint(p, like=state)
        assert step == 1 and type(restored) is type(state)
        for a, b in zip(zt.checkpoint._flatten(restored),
                        zt.checkpoint._flatten(state)):
            assert a[0] == b[0]
            if isinstance(b[1], torch.Tensor):
                assert torch.equal(a[1], b[1])
            else:
                assert a[1] == b[1]
    assert restored.t == 1 and isinstance(restored.t, int)
    m2, _ = mala.sample(_port_lj, {}, m, (0, 2))
    assert torch.isfinite(m2.q["x"]).all()


def test_npz_bfloat16_roundtrip(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
             "s": torch.tensor(1.5, dtype=torch.bfloat16),
             "b": torch.ones((), dtype=torch.float32)}
    p = save_checkpoint(str(tmp_path / "bf16.npz"), state)
    exotic = json.loads(_npz_entries(p)["__exotic__"].tobytes())
    assert exotic == {"2": ["bfloat16", [2, 3]], "1": ["bfloat16", []]}
    restored, _ = restore_checkpoint(p, device="cpu")
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], state["w"])
    assert torch.equal(restored["s"], state["s"])


def test_orbax_is_refused_and_named(tmp_path):
    with pytest.raises(ValueError, match="npz"):
        save_checkpoint(str(tmp_path / "o"), {"a": torch.ones(1)},
                        use_orbax=True)
    d = tmp_path / "orbax_dir"
    d.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        restore_checkpoint(str(d), device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_like_leaf_count_checked(tmp_path):
    p = save_checkpoint(str(tmp_path / "c"), {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(p, like={"a": torch.ones(2), "b": torch.ones(1)})


def test_exported_at_top_level():
    assert zt.save_checkpoint is save_checkpoint
    assert zt.restore_checkpoint is restore_checkpoint
