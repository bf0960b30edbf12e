"""Dense preconditioning for MCMC by coordinate whitening (port of
``zhusuan_tpu/mcmc/precondition.py``).

Estimate the posterior covariance ``Sigma = L L^T`` from warm-up draws,
then sample ``y = L^{-1} q`` under ``log p(L y)`` with identity mass:
identity-mass HMC on ``y`` is dense-mass HMC on ``q`` with
``M = (L L^T)^{-1}``, and every sampler stays unchanged. The whitened
density is a plain callable, so on the card it takes the samplers' plain
path, as any log-joint that is not a built-in does.

Typical use::

    warm, draws = hmc.run(log_joint, {}, state, key, 500, n_adapt=500)
    chol = fit_dense_preconditioner(draws["samples"]["z"], shrinkage=5.0)
    white_lj, to_white, from_white = whiten_log_joint(log_joint, "z", chol)
    wstate = hmc.init({"z": to_white(warm.q["z"])}, n_chain_dims=1)
    wstate, out = hmc.run(white_lj, {}, wstate, key, 2000)
    q_samples = from_white(out["samples"]["z"])
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn

__all__ = ["fit_dense_preconditioner", "whiten_log_joint"]


def fit_dense_preconditioner(draws, shrinkage: float = 5.0):
    """Estimate a regularised covariance Cholesky from warm-up draws.

    :param draws: ``[..., d]`` draws of one latent; the leading axes (e.g.
        iterations x chains) are flattened.
    :param shrinkage: Stan-style shrinkage toward a scaled identity:
        ``Sigma <- n/(n+s) Sigma_hat + s/(n+s) 1e-3 I`` with ``s =
        shrinkage`` pseudo-observations.
    :return: ``chol [d, d]``, the lower Cholesky factor of the regularised
        covariance (``torch.linalg.cholesky``; raises if it is not
        positive definite).
    """
    x = torch.as_tensor(draws)
    d = x.shape[-1]
    x = x.reshape(-1, d)
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    cov = (xc.T @ xc) / max(float(n - 1), 1.0)
    w = float(n) / (float(n) + float(shrinkage))
    cov = w * cov + (1.0 - w) * 1e-3 * torch.eye(d, dtype=x.dtype,
                                                 device=x.device)
    return torch.linalg.cholesky(cov)


def whiten_log_joint(log_joint, name: str, chol):
    """The whitened density and the coordinate maps for latent ``name``.

    In whitened coordinates ``y = L^{-1} q`` the density is ``log p(L y)``
    (the constant ``log|det L|`` drops out of MCMC).

    :param log_joint: the original ``log_joint(obs_dict)`` callable.
    :param name: the latent to whiten (data shape ``[d]``).
    :param chol: ``[d, d]`` lower Cholesky factor from
        :func:`fit_dense_preconditioner`.
    :return: ``(white_log_joint, to_white, from_white)``: the density over
        ``{name: y}`` and the maps ``q -> y`` and ``y -> q`` on ``[..., d]``
        tensors.
    """
    chol = torch.as_tensor(chol)
    log_joint = make_log_joint_fn(log_joint, {})

    def from_white(y):
        return y @ chol.T

    def to_white(q):
        # Solve L Y^T = Q^T for every row at once (lower triangular).
        q = torch.as_tensor(q)
        flat = q.reshape(-1, q.shape[-1])
        yt = torch.linalg.solve_triangular(chol, flat.T, upper=False)
        return yt.T.reshape(q.shape)

    def white_log_joint(obs):
        obs = dict(obs)
        obs[name] = from_white(obs[name])
        return log_joint(obs)

    return white_log_joint, to_white, from_white
