"""Mesh construction and placement helpers (port of
``zhusuan_tpu/parallel/mesh.py``) on ``torch.distributed``.

One process per device. The caller initialises the process group
(``torch.distributed.init_process_group`` with its address, world size and
rank); :func:`chain_mesh` then lays a ``DeviceMesh`` over it. Placements
mirror the JAX package's ``PartitionSpec``: JAX's ``P("chains")`` is
``(Shard(0),)``, ``P()`` is ``(Replicate(),)``, ``P(None, "tp")`` is
``(Shard(1),)`` on a 1-D mesh (one placement per mesh axis on a larger
one).

Randomness differs from the JAX package, where a sharded program is the
unsharded one laid out over devices and draws the same numbers. Here each
rank runs its own program on its local chains, drawing from its own stream,
so a sharded run equals the unsharded run only when both are fed the same
noise, sliced by rank (the samplers' ``noise=`` hooks). The samplers'
cross-chain reductions (the step-size adaptation's mean acceptance) are
taken over each rank's own chains.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from zhusuan_tpu_torch.ops._random import as_key, child_key

__all__ = [
    "chain_mesh",
    "shard_chains",
    "replicated",
    "data_parallel_grad",
    "sharded_run",
    "shard_params_tp",
    "tp_last_axis_rule",
]


def _placement_types():
    from torch.distributed.tensor import Replicate, Shard

    return Replicate, Shard


def _axis(mesh, axis_name):
    """``(index of the mesh axis, its size)``."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError("the mesh has no axis {!r}; its axes are {}."
                         .format(axis_name, names))
    i = names.index(axis_name)
    return i, mesh.shape[i]


def _to_mesh_device(x, mesh):
    x = torch.as_tensor(x)
    if mesh.device_type == "cuda":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x.to(mesh.device_type)


def _place(x, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(_to_mesh_device(x, mesh), mesh, placements)


def chain_mesh(n_devices: Optional[int] = None, axis_name: str = "chains",
               device_type: Optional[str] = None):
    """A 1-D ``DeviceMesh`` over the ranks of the initialised process
    group, over which the leading chain / particle axis is sharded.

    :param n_devices: number of ranks (default: all). Asking for more than
        the group has raises: a silently smaller mesh would make
        :func:`shard_chains` replicate arrays sized for ``n_devices``-way
        sharding.
    :param axis_name: the mesh axis's name.
    :param device_type: ``"cuda"`` or ``"cpu"`` (default: ``"cuda"`` under
        NCCL, else ``"cpu"``).
    """
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise ValueError(
            "chain_mesh needs an initialised process group, one process a "
            "device: call torch.distributed.init_process_group first.")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(
            "chain_mesh: requested {} devices but the process group has "
            "only {}.".format(n, world))
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n == world:
        return init_device_mesh(device_type, (n,),
                                mesh_dim_names=(axis_name,))
    return DeviceMesh(device_type, list(range(n)),
                      mesh_dim_names=(axis_name,))


def shard_chains(mesh, tree, axis_name: str = "chains"):
    """Place a latent / state tree with a leading chain axis so that axis
    is sharded over ``mesh``'s ``axis_name``: every tensor whose leading
    axis divides evenly becomes a DTensor sharded on it, every other
    tensor (scalars, adaptation state with broadcast leading 1s) a
    replicated one; host values (a state's ``t``) stay as they are. Every
    rank passes the same full tensors."""
    Replicate, Shard = _placement_types()
    i, n_dev = _axis(mesh, axis_name)

    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = [Replicate()] * mesh.ndim
        if x.ndim >= 1 and x.shape[0] % n_dev == 0 and x.shape[0] >= n_dev:
            spec[i] = Shard(0)
        return _place(x, mesh, spec)

    return pytree.tree_map(place, tree)


def replicated(mesh, tree):
    """Fully replicate a tree of tensors (e.g. model parameters) across
    ``mesh``."""
    Replicate, _ = _placement_types()
    return pytree.tree_map(
        lambda x: _place(x, mesh, [Replicate()] * mesh.ndim)
        if isinstance(x, torch.Tensor) else x, tree)


def _local(tree):
    from torch.distributed.tensor import DTensor

    return pytree.tree_map(
        lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def data_parallel_grad(loss_fn: Callable, mesh, axis_name: str = "dp",
                       argnums=0):
    """A data-parallel value-and-grad function: each rank computes the loss
    on its shard of the minibatch and the gradients of it, then one
    all-reduce over ``axis_name`` averages the losses and the gradients
    (replacing reference ``examples/utils/multi_gpu.py:24-60``,
    ``average_gradients``).

    Each rank's loss takes the key ``child_key(key, rank)``, the
    counterpart of the JAX package's ``fold_in(key, axis_index)``, so the
    shards draw independent noise.

    :param loss_fn: ``loss_fn(params, batch, key) -> scalar``, the loss a
        mean over the batch shard; ``key`` a Philox key pair.
    :param argnums: 0, the parameters (the only argument differentiated).
    :return: ``f(params, batch, key) -> (loss, grads)``. ``batch`` is the
        whole minibatch (each rank takes its contiguous shard of the
        leading axis, which must divide evenly) or a DTensor sharded on it;
        ``params`` plain or replicated tensors; ``key`` a
        ``torch.Generator`` or a key pair. ``grads`` has ``params``'
        structure, as plain tensors.
    """
    if argnums not in (0, (0,)):
        raise ValueError("data_parallel_grad differentiates the parameters "
                         "only (argnums=0); got {!r}.".format(argnums))
    i, n = _axis(mesh, axis_name)

    def value_and_grad(params, batch, key):
        from torch.distributed.tensor import DTensor

        rank = mesh.get_local_rank(i)
        if isinstance(batch, DTensor):
            shard = batch.to_local()
        else:
            if batch.shape[0] % n:
                raise ValueError(
                    "the batch's leading axis ({}) must divide evenly over "
                    "the {} ranks of {!r}.".format(batch.shape[0], n,
                                                   axis_name))
            m = batch.shape[0] // n
            shard = batch[rank * m:(rank + 1) * m]
        leaves, spec = pytree.tree_flatten(_local(params))
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(leaves, spec), shard,
                           child_key(as_key(key), rank))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        # One all-reduce of the loss and every gradient, packed.
        flat = torch.cat([loss.detach().reshape(1).to(grads[0].dtype)]
                         + [g.reshape(-1) for g in grads]) if grads else \
            loss.detach().reshape(1)
        dist.all_reduce(flat, group=mesh.get_group(i))
        flat = flat / n
        out, off = [], 1
        for g in grads:
            out.append(flat[off:off + g.numel()].reshape(g.shape)
                       .to(g.dtype))
            off += g.numel()
        return (flat[0].to(loss.dtype), pytree.tree_unflatten(out, spec))

    return value_and_grad


def tp_last_axis_rule(mesh, axis_name: str = "tp"):
    """The default tensor-parallel placement rule: shard the LAST (output)
    axis over ``axis_name`` for any tensor whose last axis divides evenly;
    replicate everything else. Returns ``rule(path, leaf) -> placements``
    (one a mesh axis: ``(Shard(1),)`` for a 2-D weight on a 1-D mesh,
    JAX's ``P(None, "tp")``).

    A heuristic: a tensor whose last axis is incidentally divisible gets
    sharded too; pass :func:`shard_params_tp` a custom ``rule`` (matching
    on the key path) where that matters.
    """
    Replicate, Shard = _placement_types()
    i, n_dev = _axis(mesh, axis_name)

    def rule(path, x):
        del path
        spec = [Replicate()] * mesh.ndim
        if x.ndim >= 1 and x.shape[-1] % n_dev == 0 and x.shape[-1] >= n_dev:
            spec[i] = Shard(x.ndim - 1)
        return tuple(spec)

    return rule


def shard_params_tp(mesh, params, axis_name: str = "tp", rule=None):
    """Tensor-parallel placement of a parameter tree.

    :param rule: ``rule(path, leaf) -> placements`` deciding each leaf's
        placement; ``path`` is the leaf's key path as a string (``"['w']"``,
        the JAX package's ``keystr``). Defaults to
        :func:`tp_last_axis_rule`.
    """
    if rule is None:
        rule = tp_last_axis_rule(mesh, axis_name)

    def place(path, x):
        x = torch.as_tensor(x)
        return _place(x, mesh, rule(pytree.keystr(path), x))

    return pytree.tree_map_with_path(place, params)


def sharded_run(mesh, fn: Callable, state, key, axis_name: str = "chains",
                out_chain_axis=0):
    """Run ``fn(state, key)`` on each rank's own chains: ``state``'s chain
    axis is sharded over ``mesh`` (:func:`shard_chains`), ``fn`` gets the
    local tensors (``to_local()``: the kernels see plain tensors), and each
    output tensor whose chain axis ``out_chain_axis`` names comes back as a
    DTensor sharded on that axis; any other output (a rank's own step size,
    say) is returned as the rank's plain tensor.

    The JAX package reads the outputs' shardings off its compiled program;
    here the caller states them, since a tensor's sizes cannot tell a
    chain axis from another axis of the same length.

    :param out_chain_axis: the chain axis of every output tensor, an int,
        or ``rule(path, leaf) -> axis or None`` on the output's key path
        (``pytree.keystr``). A tensor whose size there is not the local
        chain count (or None) is returned plain. A run's collected
        samples ``[n_iters, chains, ...]`` have theirs at 1: for ``fn``
        returning ``(state, samples)``, ``lambda path, x: 1 if
        path.startswith("[1]") else 0``.

    Each rank draws from its own stream: the run equals the unsharded one
    only when ``fn`` is fed the same noise, sliced by rank (see the module
    docstring).
    """
    from torch.distributed.tensor import DTensor

    Replicate, Shard = _placement_types()
    i, _ = _axis(mesh, axis_name)
    sharded = shard_chains(mesh, state, axis_name)
    n_local = {x.to_local().shape[0] for x in pytree.tree_leaves(sharded)
               if isinstance(x, DTensor)
               and x.placements[i] == Shard(0)}
    out = fn(_local(sharded), key)
    if len(n_local) != 1:
        return out
    (c,) = n_local

    def wrap(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        axis = (out_chain_axis(pytree.keystr(path), x)
                if callable(out_chain_axis) else out_chain_axis)
        if axis is None or not (axis < x.ndim and x.shape[axis] == c):
            return x
        spec = [Replicate()] * mesh.ndim
        spec[i] = Shard(axis)
        return DTensor.from_local(x, mesh, spec, run_check=False)

    return pytree.tree_map_with_path(wrap, out)
