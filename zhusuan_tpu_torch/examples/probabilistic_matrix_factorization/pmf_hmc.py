"""Probabilistic matrix factorization with alternating HMC.

Port of ``examples/probabilistic_matrix_factorization/pmf_hmc.py``
(reference ``examples/probabilistic_matrix_factorization/pmf_hmc.py``):
Normal priors on the user and item factor matrices, a ``r ~
N(sigmoid(u . v), alpha_pred)`` likelihood on the observed ratings, and
alternating HMC sweeps over ``U`` given ``V`` and ``V`` given ``U`` with
``K`` parallel chains (reference :122-138).

The latents are 3-D (``U [K, N, D]``), which the JAX package's HMC gate
does not send to a kernel (one 2-D latent), so both packages take HMC's
plain transition. :func:`sweep` takes ``noise=`` (each sampler's ``(eps,
u)``, :meth:`~zhusuan_tpu_torch.mcmc.HMC.sample`'s hook) so a test can
feed it the JAX sweep's draws.

MovieLens-1M is replaced by its loader's synthetic low-rank ratings when
absent (:func:`~zhusuan_tpu_torch.examples.utils.dataset.load_movielens1m`).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.probabilistic_matrix_factorization.pmf_hmc
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.distributions import Normal
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import HMC
from zhusuan_tpu_torch.ops._random import child_key

__all__ = ["synthetic_ratings", "load_ratings", "make_log_joints",
           "make_samplers", "sweep", "eval_rmse", "main"]

ALPHA_U = ALPHA_V = 1.0
ALPHA_PRED = 0.2 / 4.0


def synthetic_ratings(n_users=300, n_movies=200, D_true=5, n_obs=20000,
                      seed=0):
    """A small low-rank ratings set (the JAX example's, ``RandomState``
    draws); :func:`main` uses the MovieLens loader."""
    rng = np.random.RandomState(seed)
    u = rng.randn(n_users, D_true) * 0.8
    v = rng.randn(n_movies, D_true) * 0.8
    full = 1 / (1 + np.exp(-(u @ v.T)))
    ui = rng.randint(0, n_users, n_obs)
    vi = rng.randint(0, n_movies, n_obs)
    r = full[ui, vi] + 0.05 * rng.randn(n_obs)
    return ui.astype(np.int32), vi.astype(np.int32), r.astype(np.float32), (
        n_users, n_movies)


def load_ratings(max_ratings=100_000):
    """The JAX example's data: MovieLens-1M (or its synthetic stand-in),
    train and valid ratings as the training set and at most a tenth as
    many test ratings, each scaled from 1-5 to [0, 1]. Returns ``(N, M,
    (su, sv, r) train, (su, sv, r) test, synthetic)``."""
    from zhusuan_tpu_torch.examples.utils.dataset import load_movielens1m

    N, M, train, valid, test, synthetic = load_movielens1m()
    su_t = np.concatenate([train[0], valid[0]])[:max_ratings]
    sv_t = np.concatenate([train[1], valid[1]])[:max_ratings]
    r_t = ((np.concatenate([train[2], valid[2]]) - 1.0) / 4.0)[:max_ratings]
    n_eval = min(len(test[2]), max_ratings // 10)
    su_e, sv_e = test[0][:n_eval], test[1][:n_eval]
    r_e = (test[2][:n_eval] - 1.0) / 4.0
    return N, M, (su_t, sv_t, r_t), (su_e, sv_e, r_e), synthetic


def make_log_joints(su, sv, r, dtype=torch.float32, device=None):
    """The conditionals ``log p(U, r | V)`` and ``log p(V, r | U)`` over
    ``{"u": [K, N, D]}`` given ``{"v": ...}`` and the reverse
    (``pmf_hmc.py:64-92``), in ``dtype`` on ``device``."""
    kw = dict(dtype=dtype, device=device)
    su = torch.as_tensor(np.asarray(su), dtype=torch.int64, device=device)
    sv = torch.as_tensor(np.asarray(sv), dtype=torch.int64, device=device)
    r = torch.as_tensor(np.asarray(r), **kw)
    zero = torch.tensor(0.0, **kw)
    prior_u = Normal(zero, std=torch.tensor(ALPHA_U, **kw))
    prior_v = Normal(zero, std=torch.tensor(ALPHA_V, **kw))
    std_pred = torch.tensor(ALPHA_PRED, **kw)

    def log_lik(u, v):
        logits = torch.sum(u[:, su, :] * v[:, sv, :], -1)
        return torch.sum(Normal(torch.sigmoid(logits), std=std_pred)
                         .log_prob(r), dim=-1)

    def log_joint_u(obs):
        u = obs["u"]
        return (torch.sum(prior_u.log_prob(u), dim=(-1, -2))
                + log_lik(u, obs["v"]))

    def log_joint_v(obs):
        v = obs["v"]
        return (torch.sum(prior_v.log_prob(v), dim=(-1, -2))
                + log_lik(obs["u"], v))

    return log_joint_u, log_joint_v


def make_samplers(n_leapfrogs=10):
    """The two samplers: step 1e-3 with dual averaging."""
    return tuple(HMC(step_size=1e-3, n_leapfrogs=n_leapfrogs,
                     adapt_step_size=True) for _ in range(2))


def sweep(samplers, log_joints, state_u, state_v, key=None, noise=None):
    """One alternating sweep: an HMC iteration over ``U`` given ``V``, then
    over ``V`` given the new ``U`` (``pmf_hmc.py:97-108``).

    :param key: ``(k0, k1)``; the two samplers take its child keys 0 and 1
        (their draws also follow from their own iteration counts).
    :param noise: optional ``(noise_u, noise_v)``, each ``(eps, u)`` of
        :meth:`~zhusuan_tpu_torch.mcmc.HMC.sample`.
    :return: ``(state_u, state_v, acceptance_u [K], acceptance_v [K])``.
    """
    (hmc_u, hmc_v), (lj_u, lj_v) = samplers, log_joints
    nu, nv = noise if noise is not None else (None, None)
    ku = kv = None
    if noise is None:
        ku, kv = child_key(key, 0), child_key(key, 1)
    state_u, info_u = hmc_u.sample(lj_u, {"v": state_v.q["v"]}, state_u, ku,
                                   adapt_step_size=True, noise=nu)
    state_v, info_v = hmc_v.sample(lj_v, {"u": state_u.q["u"]}, state_v, kv,
                                   adapt_step_size=True, noise=nv)
    return state_u, state_v, info_u.acceptance_rate, info_v.acceptance_rate


def eval_rmse(state_u, state_v, test):
    """The test RMSE of the chains' mean predicted rating."""
    su, sv, r = test
    u, v = state_u.q["u"], state_v.q["v"]
    dev = u.device
    su = torch.as_tensor(np.asarray(su), dtype=torch.int64, device=dev)
    sv = torch.as_tensor(np.asarray(sv), dtype=torch.int64, device=dev)
    r = torch.as_tensor(np.asarray(r), dtype=u.dtype, device=dev)
    pred = torch.sigmoid(torch.sum(u[:, su, :] * v[:, sv, :], -1)).mean(0)
    return torch.sqrt(torch.mean((pred - r) ** 2))


def main(n_epochs=20, D=10, K=4, n_leapfrogs=10, max_ratings=100_000,
         device=None, seed=1237, verbose=True):
    """``n_epochs`` sweeps from ``0.1 N(0, 1)`` factors; every fifth prints
    the acceptance rates and the test RMSE. Returns ``(state_u, state_v,
    rmses)``."""
    device = torch.device("cuda:0" if device is None else device)
    N, M, train, test, synthetic = load_ratings(max_ratings)
    if synthetic and verbose:
        print("[note] MovieLens-1M not found; using synthetic ratings.")
    g = torch.Generator(device=device).manual_seed(seed)
    U = 0.1 * torch.randn((K, N, D), generator=g, device=device)
    V = 0.1 * torch.randn((K, M, D), generator=g, device=device)
    samplers = make_samplers(n_leapfrogs)
    log_joints = make_log_joints(*train, device=device)
    state_u = samplers[0].init({"u": U}, n_chain_dims=1)
    state_v = samplers[1].init({"v": V}, n_chain_dims=1)
    rmses = []
    for epoch in range(1, n_epochs + 1):
        state_u, state_v, acc_u, acc_v = sweep(
            samplers, log_joints, state_u, state_v, (seed, epoch))
        if epoch % 5 == 0:
            rmse = float(eval_rmse(state_u, state_v, test))
            rmses.append(rmse)
            if verbose:
                print("Epoch {}: acc_u = {:.3f}, acc_v = {:.3f}, test rmse "
                      "= {:.4f}".format(epoch, float(acc_u.mean()),
                                        float(acc_v.mean()), rmse))
    return state_u, state_v, rmses


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=20)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(args.epochs, device=resolve_device(args.device))


if __name__ == "__main__":
    _cli()
