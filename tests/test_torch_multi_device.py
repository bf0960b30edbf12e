"""The port's data-parallel VAE example
(``zhusuan_tpu_torch/examples/utils/multi_device.py``, port of
``examples/utils/multi_device.py``) on the CPU: a world of one rank (gloo
over a ``FileStore``, the layout it makes alone on a card with NCCL), cut to
a few steps at a small width, and its data-parallel gradient against a
plain value-and-grad, bit for bit.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from zhusuan_tpu_torch.examples.utils import multi_device
from zhusuan_tpu_torch.examples.variational_autoencoders.vae import (
    init_params,
)
from zhusuan_tpu_torch.ops._random import child_key
from zhusuan_tpu_torch.parallel import chain_mesh, data_parallel_grad


def test_main_runs_a_world_of_one_and_tears_it_down(capsys):
    assert not dist.is_initialized()
    init = init_params(torch.Generator().manual_seed(0), 784, 4)
    params = multi_device.main(steps=3, z_dim=4, per_device_batch=8,
                               device="cpu", log_every=1)
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "Devices: 1 -> mesh" in out
    losses = [float(line.split("=")[1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "3 steps on 1 devices" in out
    moved = [not torch.equal(a, b) for a, b in
             zip(pytree.tree_leaves(params), pytree.tree_leaves(init))]
    assert all(moved)


def test_world_of_one_grad_is_plain_value_and_grad_bit_for_bit():
    store_dir = multi_device.init_world_of_one(torch.device("cpu"))
    try:
        mesh = chain_mesh(axis_name="dp")
        loss_fn = multi_device.vae_loss_fn(4)
        params = init_params(torch.Generator().manual_seed(1), 784, 4)
        x = (torch.rand(16, 784, generator=torch.Generator().manual_seed(2))
             < 0.3).float()
        key = (5, 6)
        loss, grads = data_parallel_grad(loss_fn, mesh, "dp")(params, x, key)
        leaves, spec = pytree.tree_flatten(params)
        leaves = [v.clone().requires_grad_(True) for v in leaves]
        want = loss_fn(pytree.tree_unflatten(leaves, spec), x,
                       child_key(key, 0))
        want_grads = torch.autograd.grad(want, leaves)
        assert torch.equal(loss, want.detach())
        for g, w in zip(pytree.tree_leaves(grads), want_grads):
            assert torch.equal(g, w)
    finally:
        dist.destroy_process_group()
