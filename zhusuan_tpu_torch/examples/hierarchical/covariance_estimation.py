"""Full-covariance estimation: LKJ correlation prior with a scale
decomposition.

Port of ``examples/hierarchical/covariance_estimation.py``: ``Sigma =
diag(s) L L^T diag(s)`` with ``s_j ~ HalfNormal(1)``, ``L ~
LKJCholesky(K, eta=2)`` and ``x_i ~ N(0, Sigma)``; the scales ride
:class:`~zhusuan_tpu_torch.bijectors.Softplus`, the correlation factor
:class:`~zhusuan_tpu_torch.bijectors.CorrelationCholesky`, and NUTS samples
both jointly in the unconstrained space.

NUTS runs on the NUTS kernel on the card: its log-joint is the built-in
:class:`~zhusuan_tpu_torch.ops.densities.CovarianceEstimationLogJoint`, the
unconstrained density ``transform_log_joint`` would build from
:func:`build_log_joint`, which gives the maps ``to_u`` / ``to_c``.

Data: synthetic draws from a known covariance (``synthetic``), so recovery
is checkable against the truth and against the sample covariance. The JAX
example draws them with ``jax.random``; :func:`run` takes them through
``data=``, and draws its own from a seeded torch generator otherwise.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.hierarchical.covariance_estimation
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.bijectors import (
    CorrelationCholesky,
    Softplus,
    transform_log_joint,
)
from zhusuan_tpu_torch.distributions import LKJCholesky
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.mcmc import NUTS
from zhusuan_tpu_torch.ops.densities import CovarianceEstimationLogJoint

__all__ = ["TRUE_SCALES", "TRUE_CORR", "ETA", "make_data",
           "build_log_joint", "covariance_density", "make_sampler",
           "init_state", "run", "main"]

TRUE_SCALES = np.asarray([1.0, 2.0, 0.5])
TRUE_CORR = np.asarray([
    [1.0, 0.6, -0.3],
    [0.6, 1.0, 0.2],
    [-0.3, 0.2, 1.0],
])
ETA = 2.0


def make_data(n, seed=0):
    """``n`` float32 draws of ``N(0, diag(TRUE_SCALES) TRUE_CORR
    diag(TRUE_SCALES))`` from a CPU generator seeded by ``seed``; returns
    ``(x [n, 3] numpy, synthetic)``."""
    cov = np.diag(TRUE_SCALES) @ TRUE_CORR @ np.diag(TRUE_SCALES)
    chol = torch.tensor(np.linalg.cholesky(cov), dtype=torch.float32)
    g = torch.Generator().manual_seed(int(seed))
    x = torch.randn((n, 3), generator=g) @ chol.T
    return x.numpy(), True


def _solve_batch(L, z):
    """Solve ``L y = z`` for each row of ``z``, broadcasting over chain
    axes: ``L [..., K, K]``, ``z [..., n, K]`` -> ``y [..., n, K]``."""
    L, z = torch.broadcast_tensors(L[..., None, :, :], z[..., None])
    return torch.linalg.solve_triangular(L, z, upper=False)[..., 0]


def build_log_joint(x, device=None, dtype=torch.float32):
    """The constrained log-joint over ``s [..., K]`` and ``L [..., K, K]``
    (``covariance_estimation.py:59-83``)."""
    xt = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    n, k = xt.shape
    lkj = LKJCholesky(k, torch.tensor(ETA, dtype=dtype, device=device))

    def log_joint(obs):
        s, L = obs["s"], obs["L"]
        prior_s = torch.sum(-0.5 * s ** 2, dim=-1)  # HalfNormal(1) kernel
        prior_l = lkj.log_prob(L)
        # N(0, diag(s) L L' diag(s)): y_i = L^-1 (x_i / s) and
        # log|Sigma|^(1/2) = sum log s + sum log diag L.
        z = xt / s[..., None, :]
        y = _solve_batch(L, z)
        half_logdet = (torch.sum(torch.log(s), dim=-1)
                       + torch.sum(torch.log(torch.diagonal(
                           L, dim1=-2, dim2=-1)), dim=-1))
        lik = -0.5 * torch.sum(y * y, dim=(-1, -2)) - n * half_logdet
        return prior_s + prior_l + lik

    return log_joint


def covariance_density(x):
    """The NUTS kernel's built-in for the unconstrained model, and the maps
    ``(to_u, to_c)`` of ``transform_log_joint`` on the closure."""
    _, to_u, to_c = transform_log_joint(
        build_log_joint(x), {"s": Softplus(), "L": CorrelationCholesky()})
    return CovarianceEstimationLogJoint(x, eta=ETA), to_u, to_c


def make_sampler():
    return NUTS(step_size=0.1, max_tree_depth=6, adapt_step_size=True)


def init_state(n_chains, k, device=None, dtype=torch.float32):
    """The JAX example's constrained initial state: unit scales and the
    identity correlation factor."""
    kw = dict(dtype=dtype, device=device)
    return {"s": torch.ones((n_chains, k), **kw),
            "L": torch.eye(k, **kw).expand(n_chains, k, k).clone()}


def run(n=300, n_chains=16, n_iters=1200, burnin=400, seed=2, data=None,
        device=None):
    """NUTS on the posterior; returns the JAX example's summaries
    (``synthetic``, ``scale_mean``, ``corr_mean``, ``cov_mean``,
    ``cov_sd``, ``sample_cov``) and ``divergent``, the share of divergent
    transitions after burn-in.

    :param data: ``[n, K]`` observations (e.g. the JAX example's); None
        draws :func:`make_data` ``(n, seed)``.
    :param device: where NUTS runs (the card when None).
    """
    device = torch.device("cuda:0" if device is None else device)
    if data is None:
        x, synthetic = make_data(n, seed)
    else:
        x, synthetic = np.asarray(data, np.float32), True
    k = x.shape[1]
    density, to_u, to_c = covariance_density(x)
    nuts = make_sampler()
    state = nuts.init(to_u(init_state(n_chains, k, device)), n_chain_dims=1)
    state, out = nuts.run(density, {}, state, (seed, 1), n_iters,
                          n_adapt=burnin,
                          collect_fields=("samples", "divergent"))
    draws = to_c({kk: v[burnin:] for kk, v in out["samples"].items()})
    s = draws["s"].double().cpu().numpy().reshape(-1, k)
    L = draws["L"].double().cpu().numpy().reshape(-1, k, k)
    corr = L @ np.swapaxes(L, -1, -2)
    cov = s[:, :, None] * corr * s[:, None, :]
    # The large-n reference: the sample covariance (the posterior
    # concentrates there).
    sample_cov = np.cov(np.asarray(x, np.float64).T, bias=True)
    return {
        "synthetic": synthetic,
        "scale_mean": s.mean(0),
        "corr_mean": corr.mean(0),
        "cov_mean": cov.mean(0),
        "cov_sd": cov.std(0),
        "sample_cov": sample_cov,
        "divergent": float(out["divergent"][burnin:].float().mean().cpu()),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=300)
    parser.add_argument("--n-chains", type=int, default=16)
    parser.add_argument("--n-iters", type=int, default=1200)
    parser.add_argument("--burnin", type=int, default=400)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    res = run(args.n, args.n_chains, args.n_iters, args.burnin,
              device=resolve_device(args.device))
    print("posterior mean correlation:\n", np.round(res["corr_mean"], 2))
    print("true correlation:\n", TRUE_CORR)
    print("posterior mean scales:", np.round(res["scale_mean"], 2),
          "true:", TRUE_SCALES)
    return res


if __name__ == "__main__":
    main()
