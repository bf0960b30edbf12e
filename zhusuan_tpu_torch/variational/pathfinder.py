"""Pathfinder: variational inference along an L-BFGS optimization path
(Zhang, Carpenter, Gelman & Vehtari, JMLR 2022; port of
``zhusuan_tpu/variational/pathfinder.py``).

A quasi-Newton run toward the posterior mode fits a Gaussian
``N(theta_l, Sigma_l)`` at EVERY iterate, ``Sigma_l`` the L-BFGS compact
inverse-Hessian estimate, and returns draws from the approximation with the
highest Monte-Carlo ELBO along the path. Multi-path Pathfinder pools the
draws of several paths by Pareto-smoothed importance resampling.

The optimisation is the port's copy of ``optax.lbfgs()``
(:mod:`._lbfgs`), whose iterates are optax's, in a Python loop over the
flattened latent (sorted-name order); a non-finite step freezes the
iterate. The per-iterate sweep is a second Python loop carrying a rolling
``(s, y)`` pair buffer: one thin ``[D, 2m]`` QR and one ``[2m, 2m]``
Cholesky an iterate (the factorization below) and a K-draw ELBO on COMMON
random numbers (one base-normal draw set shared by every iterate, so the
argmax ranks approximations rather than Monte-Carlo noise). The sweep
keeps its best iterate with device selects: it reads nothing back. The
density is evaluated on batches of points through ``torch.func.vmap``, as
the JAX package ``vmap``s it, so any per-point log joint works.
Multi-path runs its paths one after another (each exactly as a single
path), then smooths the pooled ratios with
:func:`~zhusuan_tpu_torch.evaluation.psis_smooth_log_weights` and resamples
without replacement by Gumbel top-k (``torch.topk``).

Factorization (compact inverse BFGS, Byrd-Nocedal-Schnabel 1994, with
``H0 = diag(alpha)``):

    Sigma = diag(alpha) + B W B^T,          B = [S, diag(alpha) Y]
    W     = [[R^-T (D + Y^T diag(alpha) Y) R^-1,  -R^-T],
             [-R^-1,                               0   ]]

with ``R = triu(S^T Y)``, ``D = diag(S^T Y)``. Writing
``A = diag(alpha)^-1/2 B = Q Rt`` (thin QR) and ``E = Rt W Rt^T``:

    Sigma^1/2 = diag(alpha)^1/2 (I + Q (L - I) Q^T),   L L^T = I + E

so draws cost ``O(D m)`` each and
``log det Sigma = sum log alpha + 2 sum log diag L``. The diagonal seed
``alpha`` is the BFGS Hessian update restricted to its diagonal
(:func:`_diag_update`), seeded with ``gamma = s^T y / y^T y`` at the first
valid pair.

Random numbers: ``generator`` (a ``torch.Generator``, the default CPU one
when None) gives one Philox key; path ``p`` draws its ELBO normals and
then its final normals from ``iteration_generator(key, p)`` on the
latent's device, and the Gumbel draws of the resampling come from
``iteration_generator(key, n_paths)``. ``noise=`` replaces them (a testing
hook for feeding the JAX package's draws).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from zhusuan_tpu_torch.distributions.utils import (
    open_interval_standard_uniform,
)
from zhusuan_tpu_torch.mcmc.base import make_log_joint_fn
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator
from zhusuan_tpu_torch.variational._lbfgs import (
    lbfgs,
    value_and_grad,
    value_and_grad_from_state,
)
from zhusuan_tpu_torch.variational.laplace import ravel

__all__ = [
    "PathfinderResult",
    "MultiPathfinderResult",
    "pathfinder",
    "multipath_pathfinder",
    "pathfinder_mcmc_init",
]

_LOG_2PI = math.log(2.0 * math.pi)


class PathfinderResult(NamedTuple):
    """Output of single-path :func:`pathfinder`."""

    draws: Dict  # {name: [n_draws, ...]} approximate posterior draws
    log_p: torch.Tensor  # [n_draws] log joint at each draw
    log_q: torch.Tensor  # [n_draws] approximation density at each draw
    elbo: torch.Tensor  # scalar: ELBO of the selected approximation
    elbo_trace: torch.Tensor  # [max_iters] per-iterate ELBO estimates
    best_iter: torch.Tensor  # argmax iterate index (int32)
    mode: Dict  # the selected iterate (approximation mean)


class MultiPathfinderResult(NamedTuple):
    """Output of :func:`multipath_pathfinder`."""

    draws: Dict  # {name: [n_draws, ...]} PSIS-resampled pooled draws
    khat: float  # Pareto-k of the pooled importance ratios (> 0.7: bad)
    path_elbos: torch.Tensor  # [n_paths] per-path selected ELBOs
    log_p: torch.Tensor  # [n_draws] log joint at the resampled draws


def _lbfgs_trajectory(neg, x0, max_iters):
    """Run :func:`._lbfgs.lbfgs` and collect the iterate / gradient
    trajectory: ``(xs, gs, host_reads)``, ``xs`` and ``gs`` of shape
    ``[max_iters + 1, D]`` (position and gradient of ``neg`` at iterates
    ``theta_0 .. theta_L``), ``host_reads`` the line searches' reads."""
    optimizer = lbfgs()
    state = optimizer.init(x0)
    from_state = value_and_grad_from_state(neg)
    x, xs, gs, reads = x0, [], [], 0
    for _ in range(int(max_iters)):
        value, grad = from_state(x, state=state)
        updates, state = optimizer.update(grad, state, x, value=value,
                                          grad=grad, value_fn=neg)
        reads += state.info.host_reads
        x_new = x + updates
        # A non-finite step (a diverged line search on a nasty target)
        # would poison the whole trajectory: freeze instead.
        x_new = torch.where(torch.all(torch.isfinite(x_new)), x_new, x)
        xs.append(x)
        gs.append(grad)
        x = x_new
    xs.append(x)
    gs.append(value_and_grad(neg, x)[1])
    return torch.stack(xs), torch.stack(gs), reads


def _bfgs_factor(s_buf, y_buf, valid, alpha, jitter):
    """(Q, L, log_det_sigma, ok) for the compact inverse-Hessian at one
    iterate, from the rolling pair buffers ``[m, D]`` (rows are vectors,
    oldest first; invalid rows are zeroed) and the diagonal seed
    ``alpha [D]``."""
    m = s_buf.shape[0]
    dtype, device = s_buf.dtype, s_buf.device
    sm = s_buf * valid[:, None]
    ym = y_buf * valid[:, None]
    sty = sm @ ym.T  # [m, m] (S^T Y)_{ij} = s_i . y_j
    zero = torch.zeros((), dtype=dtype, device=device)
    # Unit diagonal for invalid pairs keeps R invertible; their beta
    # columns are zero so they contribute nothing.
    r = torch.triu(sty) + torch.diag(torch.where(valid > 0, zero, 1.0))
    dv = torch.diag(torch.where(valid > 0, torch.diagonal(sty), zero))
    yay = (ym * alpha[None]) @ ym.T  # Y^T diag(alpha) Y
    eye_m = torch.eye(m, dtype=dtype, device=device)
    r_inv = torch.linalg.solve_triangular(r, eye_m, upper=True)
    w11 = r_inv.T @ (dv + yay) @ r_inv
    w = torch.cat([torch.cat([w11, -r_inv.T], dim=1),
                   torch.cat([-r_inv, torch.zeros_like(r_inv)], dim=1)])
    # A = diag(alpha)^-1/2 [S, alpha Y] as a [D, 2m] matrix.
    inv_sqrt = 1.0 / torch.sqrt(alpha)
    a = torch.cat([(sm * inv_sqrt[None]).T,
                   (ym * torch.sqrt(alpha)[None]).T], dim=1)
    # Thin QR: Q is [D, K] with K = min(D, 2m).
    q, rt = torch.linalg.qr(a)
    kdim = q.shape[1]
    e = rt @ w @ rt.T
    eye_k = torch.eye(kdim, dtype=dtype, device=device)
    chol, info = torch.linalg.cholesky_ex(eye_k + 0.5 * (e + e.T)
                                          + jitter * eye_k)
    ok = (info == 0) & torch.all(torch.isfinite(chol))
    chol = torch.where(ok, chol, eye_k)
    log_det = torch.sum(torch.log(alpha)) + 2.0 * torch.sum(
        torch.log(torch.clamp(torch.diagonal(chol), min=1e-30)))
    return q, chol, log_det, ok


def _diag_update(alpha, s, y, sy, pair_ok, seeded):
    """Diagonal inverse-Hessian seed update (the Pathfinder paper's
    scheme): the BFGS HESSIAN update restricted to its diagonal,

        (1/alpha')_j = (1/alpha)_j - (s_j/alpha_j)^2 / (s^T diag(1/a) s)
                       + y_j^2 / (s^T y),

    seeded with ``gamma = s^T y / y^T y`` at the first valid pair.
    PD-safe: clamped away from zero."""
    gamma = sy / torch.clamp(torch.sum(y * y), min=1e-30)
    base = torch.where(seeded, alpha, gamma * torch.ones_like(alpha))
    binv = 1.0 / base
    quad = torch.clamp(torch.sum(s * s * binv), min=1e-30)
    binv_new = binv - torch.square(s * binv) / quad + y * y / sy
    alpha_new = 1.0 / torch.clamp(binv_new, min=1e-12)
    return torch.where(pair_ok, alpha_new, alpha)


def _draws_from_z(z, theta, alpha, q, chol, log_det):
    """Map standard-normal draws ``z [n, D]`` through the factor to
    ``N(theta, Sigma)`` draws, plus their exact log density."""
    d = theta.shape[0]
    eye_k = torch.eye(q.shape[1], dtype=theta.dtype, device=theta.device)
    u = z @ q  # [n, K]
    w = z + (u @ (chol - eye_k).T) @ q.T
    x = theta[None] + torch.sqrt(alpha)[None] * w
    log_q = (-0.5 * d * _LOG_2PI - 0.5 * log_det
             - 0.5 * torch.sum(z * z, dim=-1))
    return x, log_q


def _factor_draws(generator, theta, alpha, q, chol, log_det, n):
    """``n`` fresh draws from ``N(theta, Sigma)`` via the factor."""
    z = torch.randn((n, theta.shape[0]), generator=generator,
                    dtype=theta.dtype, device=theta.device)
    return _draws_from_z(z, theta, alpha, q, chol, log_det)


def _pathfinder_flat(log_posterior, unflatten, x0, n_draws, max_iters,
                     history, n_elbo_draws, jitter, generator=None,
                     noise=None):
    """Single-path core over the flattened latent. Returns flat draws.
    ``noise`` (when given) is ``(z_elbo [n_elbo_draws, D], z [n_draws,
    D])``, else both come from ``generator``, in that order."""
    d = x0.shape[0]
    dtype, device = x0.dtype, x0.device

    def neg(x):
        return -log_posterior(unflatten(x))

    batched_log_p = torch.func.vmap(
        lambda xx: log_posterior(unflatten(xx)))

    xs, gs, _ = _lbfgs_trajectory(neg, x0, max_iters)
    m = int(history)
    if noise is not None:
        z_elbo, z_final = (torch.tensor(z, dtype=dtype, device=device)
                           for z in noise)
    else:
        z_elbo = torch.randn((n_elbo_draws, d), generator=generator,
                             dtype=dtype, device=device)
        z_final = None

    s_buf = torch.zeros((m, d), dtype=dtype, device=device)
    y_buf = torch.zeros_like(s_buf)
    valid = torch.zeros(m, dtype=dtype, device=device)
    alpha = torch.ones(d, dtype=dtype, device=device)
    seeded = torch.zeros((), dtype=torch.bool, device=device)
    kdim = min(d, 2 * m)  # thin-QR column count (see _bfgs_factor)
    best_elbo = torch.full((), -math.inf, dtype=dtype, device=device)
    best_theta, best_alpha = x0, torch.ones_like(alpha)
    best_q = torch.zeros((d, kdim), dtype=dtype, device=device)
    best_chol = torch.eye(kdim, dtype=dtype, device=device)
    best_ld = torch.zeros((), dtype=dtype, device=device)
    best_it = torch.zeros((), dtype=torch.int32, device=device)
    trace = []
    with torch.no_grad():
        for it in range(int(max_iters)):
            theta, s, y = xs[it + 1], xs[it + 1] - xs[it], gs[it + 1] - gs[it]
            sy = torch.sum(s * y)
            norm_ok = sy > 1e-11 * torch.linalg.norm(s) * torch.linalg.norm(y)
            pair_ok = norm_ok & torch.all(torch.isfinite(y))
            okf = pair_ok.to(dtype)
            s_buf = torch.cat([s_buf[1:], (s * okf)[None]])
            y_buf = torch.cat([y_buf[1:], (y * okf)[None]])
            valid = torch.cat([valid[1:], okf[None]])
            alpha = _diag_update(alpha, s, y, sy, pair_ok, seeded)
            seeded = seeded | pair_ok

            qmat, chol, log_det, fac_ok = _bfgs_factor(s_buf, y_buf, valid,
                                                       alpha, jitter)
            x_draws, log_q = _draws_from_z(z_elbo, theta, alpha, qmat, chol,
                                           log_det)
            elbo = torch.mean(batched_log_p(x_draws) - log_q)
            elbo = torch.where(fac_ok & torch.isfinite(elbo), elbo,
                               -math.inf)
            trace.append(elbo)
            better = elbo > best_elbo
            best_elbo = torch.where(better, elbo, best_elbo)
            best_theta = torch.where(better, theta, best_theta)
            best_alpha = torch.where(better, alpha, best_alpha)
            best_q = torch.where(better, qmat, best_q)
            best_chol = torch.where(better, chol, best_chol)
            best_ld = torch.where(better, log_det, best_ld)
            best_it = torch.where(better, it, best_it)
        if z_final is None:
            x_draws, log_q = _factor_draws(generator, best_theta, best_alpha,
                                           best_q, best_chol, best_ld,
                                           int(n_draws))
        else:
            x_draws, log_q = _draws_from_z(z_final, best_theta, best_alpha,
                                           best_q, best_chol, best_ld)
        log_p = batched_log_p(x_draws)
    elbo_trace = torch.stack(trace) if trace else torch.zeros(
        0, dtype=dtype, device=device)
    return x_draws, log_p, log_q, best_elbo, elbo_trace, best_it, best_theta


def _probe(log_posterior, latent):
    with torch.no_grad():
        return tuple(log_posterior(latent).shape)


def pathfinder(
    meta_bn,
    observed: Dict,
    init: Dict,
    generator=None,
    n_draws: int = 1000,
    max_iters: int = 100,
    history: int = 6,
    n_elbo_draws: int = 30,
    jitter: float = 1e-8,
    *,
    noise=None,
) -> PathfinderResult:
    """Single-path Pathfinder (Zhang et al. 2022, Algorithm 1).

    :param meta_bn: model (``MetaBayesianNet`` or ``log_joint(obs_dict)``
        callable). Constrained latents: wrap with
        :func:`~zhusuan_tpu_torch.bijectors.transform_log_joint` first.
    :param observed: observation dict.
    :param init: dict of UNBATCHED initial latent values (one optimization
        path, no chain axes); the run stays on their device.
    :param generator: a ``torch.Generator`` (or a Philox key pair) in place
        of the JAX package's key; see the module docstring.
    :param n_draws: draws returned from the selected approximation.
    :param max_iters: L-BFGS iterations (the path length).
    :param history: number of ``(s, y)`` pairs in the inverse-Hessian
        estimate (the paper's J).
    :param n_elbo_draws: Monte-Carlo draws per iterate for the ELBO.
    :param noise: testing hook: ``{"z_elbo": [n_elbo_draws, D], "z":
        [n_draws, D]}``, the standard normals of the ELBO sweep and of the
        final draws (``D`` the flattened latent size, sorted-name order).
    :return: :class:`PathfinderResult`.
    """
    log_posterior = make_log_joint_fn(meta_bn, observed)
    init = {k: torch.as_tensor(v) for k, v in init.items()}
    x0, unflatten = ravel(init)
    probe = _probe(log_posterior, init)
    if probe != ():
        raise ValueError(
            "pathfinder needs an UNBATCHED latent (scalar log-joint); "
            "got log-joint shape {}. Drop the chain axes from init: "
            "multiple starting points go through "
            "multipath_pathfinder.".format(probe))
    gen = None
    if noise is None:
        gen = iteration_generator(as_key(generator), 0, x0.device)
    x_draws, log_p, log_q, elbo, trace, best_it, theta = _pathfinder_flat(
        log_posterior, unflatten, x0, int(n_draws), int(max_iters),
        int(history), int(n_elbo_draws), float(jitter), gen,
        None if noise is None else (noise["z_elbo"], noise["z"]))
    return PathfinderResult(
        draws=unflatten(x_draws),
        log_p=log_p,
        log_q=log_q,
        elbo=elbo,
        elbo_trace=trace,
        best_iter=best_it,
        mode=unflatten(theta),
    )


def pathfinder_mcmc_init(result, n_chains: int):
    """Package a Pathfinder result as an HMC/NUTS warm start: the first
    ``n_chains`` draws become chain initial positions, and the draws'
    per-coordinate inverse variance the diagonal mass (momenta
    ``p ~ N(0, M)`` mix best when ``M`` is the posterior precision).

    Usage::

        res = multipath_pathfinder(model, obs, inits, generator)
        init, mass = pathfinder_mcmc_init(res, n_chains=256)
        state = hmc.init(init, n_chain_dims=1)._replace(mass=mass)

    :param result: a :class:`PathfinderResult` or
        :class:`MultiPathfinderResult`.
    :param n_chains: chains to initialize (requires ``n_draws >=
        n_chains``; draws are already shuffled/resampled, so a prefix is
        an unbiased subset).
    :return: ``(init_latent_dict, mass_dict)``: positions shaped
        ``[n_chains, ...]``, masses shaped ``[1, ...]`` (broadcast over the
        chain axis, the ``HMCState.mass`` layout).
    """
    draws = result.draws
    first = next(iter(draws.values()))
    if int(n_chains) > first.shape[0]:
        raise ValueError(
            "n_chains ({}) exceeds the available draws ({}); rerun "
            "Pathfinder with more n_draws.".format(n_chains, first.shape[0]))
    init = {k: v[: int(n_chains)] for k, v in draws.items()}
    mass = {k: 1.0 / torch.clamp(torch.var(v, dim=0, keepdim=True,
                                           unbiased=False), min=1e-12)
            for k, v in draws.items()}
    return init, mass


def multipath_pathfinder(
    meta_bn,
    observed: Dict,
    inits: Dict,
    generator=None,
    n_draws: int = 1000,
    n_draws_per_path: int = 500,
    max_iters: int = 100,
    history: int = 6,
    n_elbo_draws: int = 30,
    jitter: float = 1e-8,
    *,
    noise=None,
) -> MultiPathfinderResult:
    """Multi-path Pathfinder (Zhang et al. 2022, Algorithm 2): run one path
    per initial point (one after another), pool the per-path draws, and
    importance-resample ``n_draws`` of them WITHOUT replacement (Gumbel
    top-k) under Pareto-smoothed weights ``p/q``.

    :param inits: dict of initial values with a LEADING path axis
        (``[n_paths, ...]`` per latent).
    :param noise: testing hook: ``{"z_elbo": [n_paths, n_elbo_draws, D],
        "z": [n_paths, n_draws_per_path, D], "gumbel": [n_paths *
        n_draws_per_path]}``, the Gumbel draws of the resampling.
    :return: :class:`MultiPathfinderResult` (``khat > 0.7`` means the
        pooled approximation misses posterior mass: increase paths or fall
        back to MCMC).
    """
    # evaluation imports mcmc, which imports this package.
    from zhusuan_tpu_torch.evaluation import psis_smooth_log_weights

    log_posterior = make_log_joint_fn(meta_bn, observed)
    inits = {k: torch.as_tensor(v) for k, v in inits.items()}
    n_paths = next(iter(inits.values())).shape[0]
    one_init = {k: v[0] for k, v in inits.items()}
    _, unflatten = ravel(one_init)
    probe = _probe(log_posterior, one_init)
    if probe != ():
        raise ValueError(
            "multipath_pathfinder: per-path latents must be unbatched "
            "beyond the leading path axis (scalar log-joint per path); "
            "got log-joint shape {}.".format(probe))
    if n_draws > n_paths * n_draws_per_path:
        # Fail before any path runs: the pool size is known up front.
        raise ValueError(
            "n_draws ({}) exceeds the pooled draw count ({}); raise "
            "n_draws_per_path or the number of paths.".format(
                n_draws, n_paths * n_draws_per_path))
    x0s = torch.stack([ravel({k: v[p] for k, v in inits.items()})[0]
                       for p in range(n_paths)])
    key = None if noise is not None else as_key(generator)
    paths = [_pathfinder_flat(
        log_posterior, unflatten, x0s[p], int(n_draws_per_path),
        int(max_iters), int(history), int(n_elbo_draws), float(jitter),
        None if key is None else iteration_generator(key, p, x0s.device),
        None if noise is None else (noise["z_elbo"][p], noise["z"][p]))
        for p in range(n_paths)]
    pooled = torch.cat([path[0] for path in paths])
    log_p = torch.cat([path[1] for path in paths])
    log_ratio = (log_p - torch.cat([path[2] for path in paths])).to(
        torch.float64)
    # PSIS-smooth the pooled ratios (one column).
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
    smoothed, khat = psis_smooth_log_weights(log_ratio[:, None])
    log_w = smoothed[:, 0]
    # Gumbel top-k = sampling WITHOUT replacement proportional to the
    # smoothed weights (the paper's recommendation).
    if noise is not None:
        gumbel = torch.as_tensor(noise["gumbel"], dtype=log_w.dtype,
                                 device=log_w.device)
    else:
        u = open_interval_standard_uniform(
            iteration_generator(key, n_paths, log_w.device), log_w.shape,
            log_w.dtype)
        gumbel = -torch.log(-torch.log(u))
    idx = torch.topk(log_w + gumbel, int(n_draws)).indices
    return MultiPathfinderResult(
        draws=unflatten(pooled[idx]),
        khat=float(khat[0]),
        path_elbos=torch.stack([path[3] for path in paths]),
        log_p=log_p[idx],
    )
