"""The acceptance configurations' measured recipes, run on the port.

Each configuration of :mod:`~zhusuan_tpu_torch.examples.utils.protocols`
(the port's copy of ``baseline_ref/configs_protocol.py`` and
``vae_protocol.py``) but the VAE protocol, which :func:`run_vae_protocol`
runs through ``fit_scan``, and each training example without a protocol
(the Bernoulli-latent, Gumbel-softmax and convolutional VAEs and
variational dropout, at their full widths on the loaders' MNIST, one
epoch by default: :func:`epoch_steps`) has a step builder in
:data:`STEPS`:
``STEPS[name](device, n_steps, seed) -> (step, extras)``, where
``step(i)`` runs training step ``i`` through the example's own functions
and returns its metric (a detached 0-d tensor, no host sync) and
``extras()`` gives what the configuration reports after its run.
:func:`run` takes ``warmup`` untimed steps, then ``steps`` timed ones, each
metric written into a preallocated device vector that is read once at the
end. The step counts default to the recipe's; the callers
(``scripts/measure_configs_torch.py`` at the full recipes, ``chip_smoke.py``
at reduced ones, ``scripts/profile_vae_sbn.py``) pass their own.

:func:`run` returns ``steps_per_sec``, ``timed_sec``, ``warmup_steps``,
``timed_steps``, the metric of the last step (``final_lb``, or
``final_mean_k`` for SGHMC), the mean metric of the first and the last
``tail`` timed steps (``first_mean``, ``last_mean``), ``finite`` and the
extras.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from zhusuan_tpu_torch.examples.bayesian_neural_nets import (
    bnn_sgmcmc,
    bnn_vi,
)
from zhusuan_tpu_torch.examples.bayesian_neural_nets import (
    variational_dropout as vdrop,
)
from zhusuan_tpu_torch.examples.sigmoid_belief_nets import sbn, sbn_vimco
from zhusuan_tpu_torch.examples.toy_examples import toy2d_intractable as toy
from zhusuan_tpu_torch.examples.utils import protocols
from zhusuan_tpu_torch.examples.utils.dataset import (
    epoch_batches,
    load_binary_mnist,
    regression_splits,
)
from zhusuan_tpu_torch.examples.variational_autoencoders import (
    bernoulli_latent_vae,
    gumbel_softmax_vae,
    iwae,
    vae,
    vae_conv,
)
from zhusuan_tpu_torch.fit import draw_keys
from zhusuan_tpu_torch.ops._random import philox_key
from zhusuan_tpu_torch.utils import tree_leaves

__all__ = ["TAIL", "STEPS", "RECIPES", "EXAMPLES", "epoch_steps", "run",
           "run_vae_protocol"]

TAIL = 100
IWAE_PARTICLES = 50
IWAE_BATCH = 64


def _no_extras():
    return {}


def toy2d_step(device, n_steps, seed=0):
    """Config #2 (``configs_protocol.py:29``): toy2d, 500 particles, Adam
    0.1 from means -2 and log-stds -5, ``elbo().sgvb()``."""
    cfg = protocols.TOY2D
    model = toy.build_toy2d_intractable(cfg["n_particles"], device=device)
    params = toy.init_params(device=device)
    optimizer = torch.optim.Adam([params[k] for k in toy.PARAM_NAMES],
                                 lr=cfg["lr"])
    train_step = toy.make_train_step(model, optimizer, cfg["n_particles"])
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)
    return (lambda i: train_step(params, keys[i])), _no_extras


def _regression_batches(cfg, device, n_steps):
    x_train, y_train, _, _, _ = regression_splits(cfg)
    idx = torch.as_tensor(protocols.minibatch_indices(
        len(x_train), cfg["batch_size"], n_steps), device=device)
    return (len(x_train), torch.as_tensor(x_train, device=device)[idx],
            torch.as_tensor(y_train, device=device)[idx])


def bnn_sgvb_step(device, n_steps, seed=1):
    """Config #4a (``configs_protocol.py:33-35``): BNN [13, 50, 1] on the
    synthetic Boston split, batch 10, 10 particles, Adam 0.01."""
    cfg = protocols.BNN_SGVB
    n_train, x, y = _regression_batches(cfg, device, n_steps)
    layers = [cfg["x_dim"], cfg["n_hidden"], 1]
    params = bnn_vi.init_params(layers, device=device)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=cfg["lr"])
    train_step = bnn_vi.make_train_step(
        bnn_vi.make_loss(layers, n_train, cfg["n_particles"]), optimizer)
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)
    return (lambda i: train_step(params, x[i], y[i], keys[i])), _no_extras


def bnn_sghmc_step(device, n_steps, seed=3):
    """Config #4b (``configs_protocol.py:37-42``): BNN [9, 50, 1] on the
    synthetic Protein split, batch 100, 20 particles, SGHMC second order,
    lr 2e-6, friction 0.2, the momentum resampled every 1000 steps; the
    metric is the particles' mean kinetic energy over both layers, the
    extra the test RMSE (standardized units) at the end."""
    cfg = protocols.BNN_SGHMC
    n_train, x, y = _regression_batches(cfg, device, n_steps)
    layers = [cfg["x_dim"], cfg["n_hidden"], 1]
    n_particles = cfg["n_particles"]
    sampler = bnn_sgmcmc.make_sampler(cfg["lr"], cfg["friction"],
                                      cfg["n_iter_resample_v"])
    gen = torch.Generator().manual_seed(seed)
    state = sampler.init(bnn_sgmcmc.init_weights(
        torch.Generator(device=device).manual_seed(seed), layers,
        n_particles), key=philox_key(gen))
    key = philox_key(gen)
    logstds = bnn_sgmcmc.init_logstds(layers, device=device)

    def step(i):
        nonlocal state
        state, mean_k = bnn_sgmcmc.e_step(
            sampler, state, logstds, x[i], y[i], layers, n_particles,
            n_train, key)
        return sum(mean_k.values()) / len(mean_k)

    def extras():
        _, _, x_test, y_test, _ = regression_splits(cfg)
        y_pred = bnn_sgmcmc.predict(
            state, logstds, torch.as_tensor(x_test, device=device), layers,
            n_particles)
        err = y_pred - torch.as_tensor(y_test, device=device)
        return {"test_rmse_standardized":
                float(torch.sqrt(torch.mean(err ** 2)))}

    return step, extras


def sbn_vimco_step(device, n_steps, seed=1234):
    """Config #5a (``configs_protocol.py:46-51``): the SBN 784-200-200-200
    on synthetic binary MNIST, batch 24, k = 10, Adam(1e-3, eps=1e-4),
    VIMCO; the metric is the importance-weighted bound."""
    cfg = protocols.SBN_VIMCO
    data = protocols.synthetic_binary_mnist(cfg["batch_size"] * n_steps,
                                            cfg["data_seed"])
    batches = torch.as_tensor(
        data.reshape(n_steps, cfg["batch_size"], cfg["x_dim"]),
        device=device)
    params = sbn.init_sbn_params(
        torch.Generator(device=device).manual_seed(seed), cfg["x_dim"],
        cfg["h_dim"])
    optimizer = torch.optim.Adam(tree_leaves(params), lr=cfg["lr"],
                                 eps=cfg["eps"])
    train_step = sbn_vimco.make_train_step(optimizer, cfg["h_dim"],
                                           cfg["n_particles"])
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)
    return (lambda i: train_step(params, batches[i], keys[i])), _no_extras


def iwae_step(device, n_steps, seed=20):
    """Config #3 part 2's step (the IWAE bound at k = 50, batch 64): the
    VAE protocol's rows in turn, each batch binarized dynamically."""
    x = torch.as_tensor(protocols.vae_train_data(), device=device)
    n_batches = x.shape[0] // IWAE_BATCH
    binarize = torch.Generator(device=device).manual_seed(seed)
    params = vae.init_params(torch.Generator(device=device).manual_seed(seed),
                             x.shape[1], protocols.VAE_Z_DIM)
    train_step = iwae.make_train_step(
        torch.optim.Adam(tree_leaves(params), lr=protocols.VAE_LR),
        protocols.VAE_Z_DIM, IWAE_PARTICLES)
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)

    def step(i):
        j = i % n_batches
        xb = x[j * IWAE_BATCH:(j + 1) * IWAE_BATCH]
        u = torch.rand(xb.shape, generator=binarize, device=device)
        return train_step(params, (u < xb).to(xb.dtype), keys[i])

    return step, _no_extras


@functools.lru_cache(maxsize=1)
def _binary_mnist_train():
    return load_binary_mnist()[0]


@functools.lru_cache(maxsize=1)
def _vdrop_data():
    return vdrop.load_data()


# Each training example without a protocol, as its own ``main`` loops
# over its data: (training inputs, batch size, first epoch, most batches
# an epoch).
EXAMPLES = {
    "bernoulli_latent_vae": (_binary_mnist_train, 128, 1, None),
    "gumbel_softmax_vae": (_binary_mnist_train, 128, 0, None),
    "vae_conv": (_binary_mnist_train, 128, 1, vae_conv.MAX_STEPS_PER_EPOCH),
    "variational_dropout": (lambda: _vdrop_data()[0], 1000, 1, None),
}


def _epoch(name, k, device=None):
    """The row indices ``[n_batches, batch_size]`` of the ``k``-th epoch
    (from 0) of example ``name``'s own loop."""
    inputs, batch_size, first_epoch, max_batches = EXAMPLES[name]
    return torch.as_tensor(epoch_batches(
        inputs().shape[0], batch_size, first_epoch + k, max_batches),
        device=device)


def epoch_steps(name):
    """The steps of one epoch of training example ``name``."""
    return len(_epoch(name, 0))


def _example_rows(name, device):
    """``rows(i)``: the row indices of step ``i`` of example ``name``'s
    own epoch loop, each epoch made on first use."""
    epochs = {0: _epoch(name, 0, device)}
    n_batches = len(epochs[0])

    def rows(i):
        k, j = divmod(i, n_batches)
        if k not in epochs:
            epochs[k] = _epoch(name, k, device)
        return epochs[k][j]

    return rows


def _mnist_batches(name, device):
    """``batch(i)``: step ``i``'s rows of the binarized MNIST."""
    x = torch.as_tensor(_binary_mnist_train(), device=device)
    rows = _example_rows(name, device)
    return lambda i: x[rows(i)]


def bernoulli_latent_vae_step(device, n_steps, seed=1234):
    """The Bernoulli-latent VAE (784-500-500-40, REINFORCE with the
    784-100-1 baseline and the moving-average center), batch 128, Adam
    1e-3; the metric is the lower bound."""
    params = bernoulli_latent_vae.init_params(
        torch.Generator(device=device).manual_seed(seed))
    train_step = bernoulli_latent_vae.make_train_step(
        torch.optim.Adam(tree_leaves(params), lr=1e-3), 40)
    batch = _mnist_batches("bernoulli_latent_vae", device)
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)
    moving_mean = torch.zeros((), device=device)

    def step(i):
        nonlocal moving_mean
        moving_mean, lb = train_step(params, moving_mean, batch(i), keys[i])
        return lb

    return step, _no_extras


def gumbel_softmax_vae_step(device, n_steps, seed=1234, epochs=10):
    """The Gumbel-softmax VAE (20 x 10 ExpConcrete latents, hidden 400),
    batch 128, Adam 1e-3, the temperature of each step's epoch (1.0 down
    to 0.5 over ``epochs``); the metric is the relaxed lower bound."""
    params = gumbel_softmax_vae.init_params(
        torch.Generator(device=device).manual_seed(seed))
    train_step = gumbel_softmax_vae.make_train_step(
        torch.optim.Adam(tree_leaves(params), lr=1e-3), 20, 10)
    n_batches = epoch_steps("gumbel_softmax_vae")
    batch = _mnist_batches("gumbel_softmax_vae", device)
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)
    temps = [gumbel_softmax_vae.temperature(e, epochs, device)
             for e in range(epochs)]

    def step(i):
        tau = temps[min(i // n_batches, epochs - 1)]
        return train_step(params, batch(i), keys[i], tau)

    return step, _no_extras


def vae_conv_step(device, n_steps, seed=1234):
    """The convolutional VAE (28x28x1 -> 14x14x32 -> 7x7x64 -> 500 -> z 40
    and back by transposed convolutions), batch 128, Adam 1e-3, 300 steps
    an epoch; the metric is the lower bound."""
    params = vae_conv.init_params(
        torch.Generator(device=device).manual_seed(seed))
    train_step = vae_conv.make_train_step(
        torch.optim.Adam(tree_leaves(params), lr=1e-3), 40)
    batch = _mnist_batches("vae_conv", device)
    keys = draw_keys(torch.Generator().manual_seed(seed), n_steps)
    return (lambda i: train_step(params, batch(i), keys[i])), _no_extras


VDROP_PARTICLES, VDROP_TEST = 10, 2000


def variational_dropout_step(device, n_steps, seed=1234):
    """Variational dropout (784-100-100-100-10, batch 1000, 10 particles,
    Adam(1e-3, eps=1e-4)); the metric is the bound a training row (the
    negative cost), the extras the last training batch's accuracy and the
    test accuracy on 2000 rows from 100 particles."""
    x_train, y_train, x_test, y_test, _ = _vdrop_data()
    n_train = x_train.shape[0]
    net_size = [x_train.shape[1], *vdrop.NET_HIDDEN, 10]
    params = vdrop.init_params(
        torch.Generator(device=device).manual_seed(seed), net_size)
    train_step = vdrop.make_train_step(
        torch.optim.Adam(tree_leaves(params), lr=1e-3, eps=1e-4), net_size,
        n_train, VDROP_PARTICLES)
    x_d = torch.as_tensor(x_train, device=device)
    y_d = torch.as_tensor(y_train, device=device)
    rows = _example_rows("variational_dropout", device)
    gen = torch.Generator().manual_seed(seed)
    keys = draw_keys(gen, n_steps)
    last_acc = [None]

    def step(i):
        idx = rows(i)
        cost, last_acc[0] = train_step(params, x_d[idx], y_d[idx], keys[i])
        return -cost

    def extras():
        with torch.no_grad():
            _, acc = vdrop.loss_fn(
                params, torch.as_tensor(x_test[:VDROP_TEST], device=device),
                torch.as_tensor(y_test[:VDROP_TEST], device=device),
                draw_keys(gen, 1)[0], net_size, n_train, 100)
        return {"train_acc_last_batch": float(last_acc[0]),
                "test_acc": float(acc)}

    return step, extras


STEPS = {"toy2d": toy2d_step, "bnn_sgvb": bnn_sgvb_step,
         "bnn_sghmc": bnn_sghmc_step, "sbn_vimco": sbn_vimco_step,
         "iwae": iwae_step, "bernoulli_latent_vae": bernoulli_latent_vae_step,
         "gumbel_softmax_vae": gumbel_softmax_vae_step,
         "vae_conv": vae_conv_step,
         "variational_dropout": variational_dropout_step}
RECIPES = {"toy2d": protocols.TOY2D, "bnn_sgvb": protocols.BNN_SGVB,
           "bnn_sghmc": protocols.BNN_SGHMC,
           "sbn_vimco": protocols.SBN_VIMCO}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(name, device, warmup=None, steps=None, tail=TAIL, seed=None):
    """``warmup`` untimed then ``steps`` timed steps of configuration
    ``name`` (the recipe's counts by default), timed by the host clock with
    the device synchronized at both ends."""
    # A training example without a protocol: one epoch, no untimed steps.
    recipe = RECIPES.get(name) or (
        {"warmup_steps": 0, "timed_steps": epoch_steps(name)}
        if name in EXAMPLES else {})
    warmup = recipe["warmup_steps"] if warmup is None else int(warmup)
    steps = recipe["timed_steps"] if steps is None else int(steps)
    kwargs = {} if seed is None else {"seed": seed}
    step, extras = STEPS[name](device, warmup + steps, **kwargs)
    values = torch.empty(warmup + steps, dtype=torch.float64, device=device)
    for i in range(warmup):
        values[i] = step(i)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        values[i] = step(i)
    _sync(device)
    seconds = time.perf_counter() - t0
    timed = values[warmup:].cpu().numpy()
    tail = min(tail, steps)
    metric = "final_mean_k" if name == "bnn_sghmc" else "final_lb"
    return {"steps_per_sec": steps / seconds, "timed_sec": seconds,
            "warmup_steps": warmup, "timed_steps": steps,
            metric: float(timed[-1]),
            "first_mean": float(timed[:tail].mean()),
            "last_mean": float(timed[-tail:].mean()),
            "finite": bool(np.isfinite(timed).all()), **extras()}


def run_vae_protocol(device, epochs=protocols.VAE_EPOCHS, seed=1,
                     callback=None):
    """Config #3 part 1 on ``vae_protocol.py``: :func:`~zhusuan_tpu_torch.
    examples.variational_autoencoders.vae.fit_protocol` (one ``fit_scan``
    epoch at a time); steps/s is the median over the last three epochs.

    :return: ``(params, record)``.
    """
    params, curve, seconds = vae.fit_protocol(device, seed=seed,
                                              epochs=epochs,
                                              callback=callback)
    n_batches = protocols.VAE_N_TRAIN // protocols.VAE_BATCH
    rates = [n_batches / s for s in seconds[-3:]]
    return params, {"steps_per_sec": float(np.median(rates)),
                    "epoch_sec": seconds, "elbo_curve": curve,
                    "steps_per_epoch": n_batches,
                    "finite": bool(np.isfinite(curve).all())}
