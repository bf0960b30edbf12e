"""``zhusuan_tpu_torch/parallel`` on a CPU gloo process group of two ranks
against single-process runs and against ``zhusuan_tpu/parallel`` on a
2-device CPU mesh.

Every check of the file runs in ONE spawned group (two processes started
once, module-scoped; each writes its results to a file), so the file costs
a few seconds. The checks: the deterministic data-parallel loss and
gradients against the single-process values at 1e-12, and against the JAX
package's ``data_parallel_grad`` at 1e-10; the stochastic loss against the
manual per-shard fold (``child_key(key, rank)``) at 1e-10; a chain-sharded
HMC run fed the unsharded run's noise, sliced by rank, against the
unsharded run at 1e-12, and a run collecting its samples over as many
iterations as each rank has chains, whose samples' stated chain axis (1) is
the one sharded; the placements, which mirror the JAX tests'
``PartitionSpec`` s (``P(None, "tp")`` is ``(Shard(1),)``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import zhusuan_tpu_torch as zt
from zhusuan_tpu_torch.ops._random import child_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
F64 = torch.float64
KEY = (3, 7)
HMC_ITERS = 20
HMC_CHAINS = 64
HMC_DIM = 8
# As many collected iterations as a rank has chains: the samples' sizes
# cannot tell their iteration axis from their chain axis.
COLLECT_ITERS = HMC_CHAINS // WORLD


# --------------------------------------------------------------------- #
# The problems, shared by the ranks and the single-process references
# --------------------------------------------------------------------- #
def _det_problem():
    params = {"w": torch.as_tensor(np.random.RandomState(0).randn(5, 3)),
              "b": torch.zeros(3, dtype=F64)}
    batch = torch.as_tensor(np.random.RandomState(1).randn(64, 5))
    return params, batch


def _det_loss(p, b, key):
    del key
    pred = b @ p["w"] + p["b"]
    return torch.mean(pred ** 2)


def _sto_problem():
    params = {"mu": torch.tensor(1.5, dtype=F64)}
    batch = torch.as_tensor(np.random.RandomState(2).randn(32, 4))
    return params, batch


def _sto_loss(p, b, key):
    gen = torch.Generator().manual_seed((key[0] << 32) | key[1])
    noise = torch.randn(b.shape, generator=gen, dtype=b.dtype)
    return torch.mean((b + noise - p["mu"]) ** 2)


def _hmc_problem():
    std = torch.linspace(0.5, 2.0, HMC_DIM, dtype=F64)

    def lj(obs):
        return torch.sum(-0.5 * (obs["x"] / std) ** 2, -1)

    hmc = zt.HMC(step_size=0.4, n_leapfrogs=5)
    state0 = hmc.init({"x": torch.as_tensor(np.random.RandomState(4).randn(
        HMC_CHAINS, HMC_DIM))}, n_chain_dims=1)
    g = torch.Generator().manual_seed(5)
    n = max(HMC_ITERS, COLLECT_ITERS)
    eps = torch.randn(n, HMC_CHAINS, HMC_DIM, generator=g, dtype=F64)
    u = torch.rand(n, HMC_CHAINS, generator=g, dtype=F64)
    return hmc, lj, state0, eps, u


def _hmc_run(state, rank=0, world=1, n_iters=HMC_ITERS, collect=False):
    """The run on the chains of ``state``, fed the noise of chains
    ``[rank c, (rank + 1) c)``, ``c`` the chains of ``state``; with
    ``collect``, ``(state, samples [n_iters, c, dim])``."""
    hmc, lj, _, eps, u = _hmc_problem()
    c = state.q["x"].shape[0]
    sl = slice(rank * c, (rank + 1) * c)
    samples = []
    for i in range(n_iters):
        state, _ = hmc.sample(lj, {}, state, noise=(eps[i, sl], u[i, sl]))
        samples.append(state.q["x"])
    return (state, torch.stack(samples)) if collect else state


# --------------------------------------------------------------------- #
# The ranks
# --------------------------------------------------------------------- #
def _worker(rank, world, port, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from zhusuan_tpu_torch.parallel import (
        chain_mesh,
        data_parallel_grad,
        replicated,
        shard_chains,
        shard_params_tp,
        sharded_run,
        tp_last_axis_rule,
    )

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{}".format(
        port), rank=rank, world_size=world)
    res = {}
    try:
        chain_mesh(world + 1)
    except ValueError as e:
        res["too_many"] = str(e)
    mesh = chain_mesh()
    res["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)

    placed = shard_chains(mesh, {"x": torch.zeros(8, 3), "s": torch.zeros(()),
                                 "m": torch.zeros(1, 3), "t": 4})
    res["shard_chains"] = {k: repr(v.placements) for k, v in placed.items()
                           if isinstance(v, DTensor)}
    res["shard_chains_local"] = tuple(placed["x"].to_local().shape)
    res["shard_chains_host"] = placed["t"]
    rep = replicated(mesh, {"a": torch.ones(3, 3), "b": torch.zeros(())})
    res["replicated"] = {k: repr(v.placements) for k, v in rep.items()}

    tp = init_device_mesh("cpu", (world,), mesh_dim_names=("tp",))
    params = {"w": torch.ones(4, 16), "stats": torch.ones(3, 16),
              "b": torch.ones(5)}
    heuristic = shard_params_tp(tp, params)

    def rule(path, leaf):
        if "stats" in path:
            from torch.distributed.tensor import Replicate

            return (Replicate(),)
        return tp_last_axis_rule(tp, "tp")(path, leaf)

    explicit = shard_params_tp(tp, params, rule=rule)
    res["tp"] = {"heuristic": {k: repr(v.placements)
                               for k, v in heuristic.items()},
                 "explicit": {k: repr(v.placements)
                              for k, v in explicit.items()}}
    mesh2 = init_device_mesh("cpu", (1, world), mesh_dim_names=("dp", "tp"))
    res["tp_2d"] = repr(shard_params_tp(mesh2, params)["w"].placements)

    dp = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
    p, b = _det_problem()
    loss, grads = data_parallel_grad(_det_loss, dp)(p, b, KEY)
    res["det"] = (loss, grads)
    rb = replicated(dp, p)
    from torch.distributed.tensor import Shard

    sb = shard_chains(dp, {"b": b}, axis_name="dp")["b"]
    assert sb.placements == (Shard(0),)
    res["det_dtensor"] = data_parallel_grad(_det_loss, dp)(rb, sb, KEY)
    p, b = _sto_problem()
    res["sto"] = data_parallel_grad(_sto_loss, dp)(p, b, KEY)

    _, _, state0, _, _ = _hmc_problem()
    out = sharded_run(mesh, lambda st, key: _hmc_run(st, rank, world),
                      state0, None)
    res["hmc_placement"] = repr(out.q["x"].placements)
    res["hmc_q"] = out.q["x"].full_tensor()
    res["hmc_t"] = out.t
    st, samples = sharded_run(
        mesh, lambda st, key: _hmc_run(st, rank, world, COLLECT_ITERS, True),
        state0, None,
        out_chain_axis=lambda path, x: 1 if path.startswith("[1]") else 0)
    res["collect"] = {"q": repr(st.q["x"].placements),
                      "samples": repr(samples.placements),
                      "local": tuple(samples.to_local().shape),
                      "full": samples.full_tensor(),
                      "plain": [k for k, v in st._asdict().items()
                                if isinstance(v, torch.Tensor)
                                and not isinstance(v, DTensor)]}
    torch.save(res, os.path.join(out_dir, "rank{}.pt".format(rank)))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the group once; return each rank's results."""
    out = str(tmp_path_factory.mktemp("gloo"))
    port = _free_port()
    code = ("import sys; sys.path.insert(0, {!r}); "
            "from tests.test_torch_parallel import _worker; "
            "_worker(int(sys.argv[1]), {}, {}, {!r})").format(
                REPO, WORLD, port, out)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(os.path.join(out, "rank{}.pt".format(r)),
                       weights_only=False) for r in range(WORLD)]


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=0)


def test_deterministic_grad_matches_single_process(ranks):
    p, b = _det_problem()
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = _det_loss(leaves, b, None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for r in ranks:
        for field in ("det", "det_dtensor"):
            got_loss, got_grads = r[field]
            _close(got_loss, loss.detach(), 1e-12)
            for k, g in zip(leaves, grads):
                _close(got_grads[k], g, 1e-12)


def test_deterministic_grad_matches_jax_on_a_two_device_mesh(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from zhusuan_tpu.parallel import data_parallel_grad as jax_dpg

    if len(jax.devices()) < WORLD:
        pytest.skip("needs {} JAX CPU devices".format(WORLD))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    p, b = _det_problem()
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    def loss_fn(p, b, key):
        del key
        return jnp.mean((b @ p["w"] + p["b"]) ** 2)

    loss, grads = jax_dpg(loss_fn, mesh)(jp, jnp.asarray(b.numpy()),
                                         jax.random.PRNGKey(0))
    got_loss, got_grads = ranks[0]["det"]
    _close(got_loss, np.asarray(loss), 1e-10)
    for k in jp:
        _close(got_grads[k], np.asarray(grads[k]), 1e-10)


def test_stochastic_loss_matches_manual_shard_fold(ranks):
    p, b = _sto_problem()
    shards = b.reshape(WORLD, -1, b.shape[-1])
    mu = p["mu"].clone().requires_grad_(True)
    manual = sum(_sto_loss({"mu": mu}, shards[i], child_key(KEY, i))
                 for i in range(WORLD)) / WORLD
    (g,) = torch.autograd.grad(manual, [mu])
    for r in ranks:
        loss, grads = r["sto"]
        _close(loss, manual.detach(), 1e-10)
        _close(grads["mu"], g, 1e-10)
    # The shards drew different noise: not the unsharded loss.
    assert abs(float(ranks[0]["sto"][0])
               - float(_sto_loss(p, b, child_key(KEY, 0)))) > 1e-6


def test_sharded_hmc_fed_sliced_noise_matches_unsharded(ranks):
    _, _, state0, _, _ = _hmc_problem()
    want = _hmc_run(state0)
    for r in ranks:
        assert r["hmc_placement"] == "(Shard(dim=0),)"
        assert r["hmc_t"] == HMC_ITERS
        _close(r["hmc_q"], want.q["x"], 1e-12)


def test_collected_samples_shard_on_their_stated_chain_axis(ranks):
    _, _, state0, _, _ = _hmc_problem()
    _, want = _hmc_run(state0, n_iters=COLLECT_ITERS, collect=True)
    assert want.shape == (COLLECT_ITERS, HMC_CHAINS, HMC_DIM)
    for r in ranks:
        got = r["collect"]
        assert got["q"] == "(Shard(dim=0),)"
        assert got["samples"] == "(Shard(dim=1),)"
        assert got["local"] == (COLLECT_ITERS, COLLECT_ITERS, HMC_DIM)
        _close(got["full"], want, 1e-12)
        assert "step_size" in got["plain"]


def test_placements_mirror_the_partition_specs(ranks):
    for r in ranks:
        assert r["mesh"] == ((WORLD,), ("chains",))
        assert "requested 3 devices" in r["too_many"]
        assert r["shard_chains"] == {"x": "(Shard(dim=0),)",
                                     "s": "(Replicate(),)",
                                     "m": "(Replicate(),)"}
        assert r["shard_chains_local"] == (8 // WORLD, 3)
        assert r["shard_chains_host"] == 4
        assert r["replicated"] == {"a": "(Replicate(),)",
                                   "b": "(Replicate(),)"}
        # JAX: placed["w"].sharding.spec == P(None, "tp"); "stats" P().
        assert r["tp"]["heuristic"] == {"w": "(Shard(dim=1),)",
                                        "stats": "(Shard(dim=1),)",
                                        "b": "(Replicate(),)"}
        assert r["tp"]["explicit"] == {"w": "(Shard(dim=1),)",
                                       "stats": "(Replicate(),)",
                                       "b": "(Replicate(),)"}
        assert r["tp_2d"] == "(Replicate(), Shard(dim=1))"


def test_errors_outside_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        zt.parallel.chain_mesh()

    class _Mesh:
        mesh_dim_names = ("dp",)
        shape = (2,)

    with pytest.raises(ValueError, match="argnums"):
        zt.parallel.data_parallel_grad(_det_loss, _Mesh(), argnums=1)
    with pytest.raises(ValueError, match="no axis"):
        zt.parallel.data_parallel_grad(_det_loss, _Mesh(), axis_name="x")
