"""The measured recipes of the acceptance configurations, and their data.

The port's copies of ``baseline_ref/configs_protocol.py`` (the recipes of
configs #2 toy2d SGVB, #4 BNN SGVB and SGHMC, #5 SBN VIMCO and SVGP, with
their minibatch order and synthetic binary MNIST) and of
``baseline_ref/vae_protocol.py`` (config #3's VAE protocol: the 10k subset
of synthetic MNIST, its per-epoch permutations and constants). The
regression splits are :func:`~zhusuan_tpu_torch.examples.utils.dataset.
regression_splits`. Everything is numpy and deterministic; a CPU test
holds these copies equal to the files they come from.
"""

from __future__ import annotations

import numpy as np

from zhusuan_tpu_torch.examples.utils.dataset import _synthetic_mnist

__all__ = [
    "TOY2D", "BNN_SGVB", "BNN_SGHMC", "SBN_VIMCO", "SVGP",
    "minibatch_indices", "synthetic_binary_mnist",
    "VAE_N_TRAIN", "VAE_BATCH", "VAE_EPOCHS", "VAE_Z_DIM", "VAE_LR",
    "VAE_SHUFFLE_SEED", "vae_train_data", "vae_permutations",
]

# --------------------------------------------- configs_protocol.py:27-57 #
TOY2D = dict(n_particles=500, lr=0.1, warmup_steps=50, timed_steps=16000)

# Boston-housing protocol (bnn_vi.py): layers [13, 50, 1], batch 10,
# lb_samples 10, Adam(0.01).
BNN_SGVB = dict(n_train_raw=506, x_dim=13, n_hidden=50, batch_size=10,
                n_particles=10, lr=0.01, warmup_steps=50, timed_steps=8000,
                data_seed=42)

# Protein protocol (bnn_sgmcmc.py): layers [9, 50, 1], batch 100,
# 20 particles, SGHMC(2e-6, friction 0.2, resample 1000, 2nd order).
BNN_SGHMC = dict(n_train_raw=45730, x_dim=9, n_hidden=50, batch_size=100,
                 n_particles=20, lr=2e-6, friction=0.2,
                 n_iter_resample_v=1000, warmup_steps=50, timed_steps=8000,
                 data_seed=7)

# MNIST protocol (sbn_vimco.py): x_dim 784, h_dim 200, batch 24, k=10,
# Adam(1e-3, eps=1e-4).
SBN_VIMCO = dict(x_dim=784, h_dim=200, batch_size=24, n_particles=10,
                 lr=1e-3, eps=1e-4, warmup_steps=30, timed_steps=2000,
                 data_seed=1234)

# Boston protocol (svgp.py defaults): 100 inducing points, 20 particles,
# full batch (455 <= 5000), Adam(1e-2).
SVGP = dict(n_train_raw=506, x_dim=13, n_z=100, n_particles=20, lr=1e-2,
            warmup_steps=30, timed_steps=600, data_seed=42)


def minibatch_indices(n_train, batch_size, n_steps, seed=0):
    """``configs_protocol.py:96-109``: epoch-wise permutations flattened to
    ``n_steps`` minibatches of indices, ``[n_steps, batch_size]``."""
    rng = np.random.RandomState(seed)
    out = []
    step = 0
    while step < n_steps:
        perm = rng.permutation(n_train)
        for t in range(n_train // batch_size):
            if step >= n_steps:
                break
            out.append(perm[t * batch_size:(t + 1) * batch_size])
            step += 1
    return np.stack(out)


def synthetic_binary_mnist(n, seed):
    """``configs_protocol.py:112-125``: deterministic {0, 1} MNIST-shaped
    rows (blurred random strokes, thresholded), ``[n, 784]`` float32."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, 28, 28)
    k = np.array([0.25, 0.5, 0.25])
    for axis in (1, 2):
        imgs = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, imgs)
    flat = imgs.reshape(n, 784)
    flat = flat - flat.min(1, keepdims=True)
    flat = flat / np.maximum(flat.max(1, keepdims=True), 1e-9)
    return (flat > 0.55).astype(np.float32)


# ---------------------------------------------------- vae_protocol.py #
VAE_N_TRAIN = 10000
VAE_BATCH = 128
VAE_EPOCHS = 20
VAE_Z_DIM = 40
VAE_LR = 1e-3
VAE_SHUFFLE_SEED = 20260817


def vae_train_data():
    """``vae_protocol.py:load_train``: the first ``VAE_N_TRAIN`` rows of
    synthetic MNIST's training split, real-valued, float32."""
    return np.asarray(_synthetic_mnist()[0][:VAE_N_TRAIN], dtype=np.float32)


def vae_permutations():
    """``vae_protocol.py:permutations``: the per-epoch shuffles."""
    rng = np.random.RandomState(VAE_SHUFFLE_SEED)
    return [rng.permutation(VAE_N_TRAIN) for _ in range(VAE_EPOCHS)]
