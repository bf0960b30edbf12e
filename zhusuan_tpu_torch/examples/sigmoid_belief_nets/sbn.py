"""Shared model and variational builders of the sigmoid belief net examples.

Port of ``examples/sigmoid_belief_nets/sbn.py`` (parity: reference
``examples/sigmoid_belief_nets/sbn_vimco.py:17-43``): a generative stack of
three Bernoulli layers ``h3 -> h2 -> h1 -> x`` and a mirrored bottom-up
Bernoulli inference net ``x -> h1 -> h2 -> h3``. The layers' samples take
the parameters' dtype (float32 in the JAX example, where a float32 sample
times float64 weights promotes; torch's product needs one dtype).
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.examples.utils.nn import init_linear, linear_apply
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net

__all__ = ["init_sbn_params", "build_sbn", "build_q_net"]


def init_sbn_params(generator, x_dim, h_dim, dtype=torch.float32):
    """He-normal dense layers drawn from ``generator`` (on the device they
    go to), generative first, then inference."""
    return {
        # generative: h3 -> h2 -> h1 -> x
        "g_h3_h2": init_linear(generator, h_dim, h_dim, dtype),
        "g_h2_h1": init_linear(generator, h_dim, h_dim, dtype),
        "g_h1_x": init_linear(generator, h_dim, x_dim, dtype),
        # inference: x -> h1 -> h2 -> h3
        "q_x_h1": init_linear(generator, x_dim, h_dim, dtype),
        "q_h1_h2": init_linear(generator, h_dim, h_dim, dtype),
        "q_h2_h3": init_linear(generator, h_dim, h_dim, dtype),
    }


def build_sbn(params, n, x_dim, h_dim, n_particles):
    """The generative net p(h3) p(h2|h3) p(h1|h2) p(x|h1), in the
    parameters' dtype and on their device."""
    w = params["g_h3_h2"]["w"]
    dtype = w.dtype

    @meta_bayesian_net()
    def sbn():
        bn = BayesianNet()
        h3 = bn.bernoulli(
            "h3", torch.zeros([n, h_dim], dtype=dtype, device=w.device),
            group_ndims=1, n_samples=n_particles, dtype=dtype)
        h2 = bn.bernoulli(
            "h2", linear_apply(params["g_h3_h2"], h3.tensor),
            group_ndims=1, dtype=dtype)
        h1 = bn.bernoulli(
            "h1", linear_apply(params["g_h2_h1"], h2.tensor),
            group_ndims=1, dtype=dtype)
        bn.bernoulli(
            "x", linear_apply(params["g_h1_x"], h1.tensor),
            group_ndims=1, dtype=dtype)
        return bn

    return sbn()


def build_q_net(params, x, h_dim, n_particles, key, noise=None):
    """The inference net q(h1|x) q(h2|h1) q(h3|h2). ``key`` seeds its
    nodes' generators; ``noise={"h1": u1, "h2": u2, "h3": u3}`` replaces
    their uniforms (testing hook)."""
    dtype = params["q_x_h1"]["w"].dtype
    bn = BayesianNet(key=key, noise=noise)
    h1 = bn.bernoulli(
        "h1", linear_apply(params["q_x_h1"], x), group_ndims=1,
        n_samples=n_particles, dtype=dtype)
    h2 = bn.bernoulli(
        "h2", linear_apply(params["q_h1_h2"], h1.tensor),
        group_ndims=1, dtype=dtype)
    bn.bernoulli(
        "h3", linear_apply(params["q_h2_h3"], h2.tensor),
        group_ndims=1, dtype=dtype)
    return bn
