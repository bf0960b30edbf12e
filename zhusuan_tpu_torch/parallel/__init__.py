"""Device-mesh parallelism: chain sharding and data parallelism across
processes (port of ``zhusuan_tpu/parallel``).

The JAX package shards arrays over a ``jax.sharding.Mesh`` of the devices
one program sees. The port runs one process per device under
``torch.distributed`` (NCCL on the cards, gloo on the CPU) and places
tensors as DTensors over a ``DeviceMesh``:

- :func:`chain_mesh` / :func:`shard_chains` shard the leading chain /
  particle axis across ranks; :func:`sharded_run` runs a sampler on each
  rank's own chains;
- :func:`data_parallel_grad` averages minibatch gradients over the mesh
  with one all-reduce, replacing ``average_gradients`` (reference
  ``examples/utils/multi_gpu.py:24-60``);
- :func:`shard_params_tp` / :func:`tp_last_axis_rule` place parameters for
  tensor parallelism.
"""

from zhusuan_tpu_torch.parallel.mesh import (
    chain_mesh,
    data_parallel_grad,
    replicated,
    shard_chains,
    shard_params_tp,
    sharded_run,
    tp_last_axis_rule,
)

__all__ = [
    "chain_mesh",
    "shard_chains",
    "replicated",
    "data_parallel_grad",
    "shard_params_tp",
    "sharded_run",
    "tp_last_axis_rule",
]
