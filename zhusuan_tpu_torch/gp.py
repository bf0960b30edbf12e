"""Gaussian processes: the kernel zoo, exact regression, the collapsed
sparse (Titsias) bound and the uncollapsed whitened SVGP bound (port of
``zhusuan_tpu/gp.py``).

Every Gram matrix is a squared-distance expansion around one
``[n, d] @ [d, m]`` matmul; every solve goes through a Cholesky factor and
a triangular solve (``torch.linalg.cholesky`` / ``solve_triangular``, as
the JAX module uses ``jnp.linalg.cholesky`` and ``solve_triangular``,
outside any kernel of its own). Everything is differentiable by autograd
in the kernel hyperparameters, the noise, the inducing inputs and the
SVGP state. Hyperparameters may be Python numbers or tensors; a Python
number takes the inputs' dtype (as a weakly typed JAX scalar does).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "RBF",
    "Matern12",
    "Matern32",
    "Matern52",
    "Linear",
    "Periodic",
    "RationalQuadratic",
    "Constant",
    "Sum",
    "Product",
    "GPPosterior",
    "gp_log_marginal",
    "gp_regression",
    "sgpr_elbo",
    "sgpr_predict",
    "GaussianLikelihood",
    "BernoulliLikelihood",
    "PoissonLikelihood",
    "SVGPState",
    "svgp_init",
    "svgp_marginals",
    "svgp_elbo",
    "svgp_predict",
    "svgp_state_from_numpy",
    "svgp_state_to_numpy",
]


def _param(value, like):
    """A hyperparameter as a tensor: a tensor as it is (autograd intact),
    a Python number in ``like``'s dtype and on its device."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _max0(x):
    """``jnp.maximum(x, 0.)``: ties split the gradient, as JAX's do."""
    return torch.maximum(x, x.new_zeros(()))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sq_dists(x, z):
    """Pairwise squared distances ``[n, m]`` by the matmul expansion
    ``|x|^2 + |z|^2 - 2 x z'``, clamped at zero (it can go slightly
    negative in floating point)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    z2 = torch.sum(z * z, dim=-1, keepdim=True)
    return _max0(x2 + z2.T - 2.0 * (x @ z.T))


def _solve_lower(L, b):
    """``L^{-1} b`` for lower-triangular ``L`` and a vector or matrix
    ``b``."""
    if b.ndim == 1:
        return torch.linalg.solve_triangular(L, b[:, None],
                                             upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


class _Kernel:
    """Base: ``k(x, z) -> [n, m]`` Gram matrix, ``kdiag(x) -> [n]``;
    ``+`` and ``*`` build :class:`Sum` / :class:`Product` kernels."""

    def __call__(self, x, z):
        raise NotImplementedError

    def kdiag(self, x):
        raise NotImplementedError

    def __add__(self, other):
        return Sum(self, other)

    def __mul__(self, other):
        return Product(self, other)


class _Stationary(_Kernel):
    """Stationary kernel with ARD lengthscales and an output variance.

    :param lengthscale: scalar or ``[d]`` per-dimension lengthscales.
    :param variance: scalar output variance ``k(x, x)``.
    """

    def __init__(self, lengthscale=1.0, variance=1.0):
        self.lengthscale = lengthscale
        self.variance = variance

    def _r2(self, x, z):
        ell = _param(self.lengthscale, x)
        return _sq_dists(x / ell, z / ell)

    def kdiag(self, x):
        return _param(self.variance, x).expand(x.shape[:-1])


class RBF(_Stationary):
    """Squared exponential (ARD): ``v * exp(-r^2 / 2)``."""

    def __call__(self, x, z):
        return _param(self.variance, x) * torch.exp(-0.5 * self._r2(x, z))


class Matern12(_Stationary):
    """Exponential kernel ``v * exp(-r)`` (Matern nu = 1/2)."""

    def __call__(self, x, z):
        r = torch.sqrt(self._r2(x, z) + 1e-36)
        return _param(self.variance, x) * torch.exp(-r)


class Matern32(_Stationary):
    """Matern nu = 3/2: ``v (1 + s r) exp(-s r)``, ``s = sqrt(3)``."""

    def __call__(self, x, z):
        r = torch.sqrt(self._r2(x, z) + 1e-36)
        s = torch.sqrt(torch.tensor(3.0, dtype=r.dtype, device=r.device))
        return _param(self.variance, x) * (1.0 + s * r) * torch.exp(-s * r)


class Matern52(_Stationary):
    """Matern nu = 5/2: ``v (1 + s r + s^2 r^2 / 3) exp(-s r)``,
    ``s = sqrt(5)``."""

    def __call__(self, x, z):
        r2 = self._r2(x, z)
        r = torch.sqrt(r2 + 1e-36)
        s = torch.sqrt(torch.tensor(5.0, dtype=r.dtype, device=r.device))
        return (_param(self.variance, x)
                * (1.0 + s * r + (5.0 / 3.0) * r2) * torch.exp(-s * r))


class Periodic(_Kernel):
    """Exp-sine-squared periodic kernel (MacKay):
    ``v * exp(-2 sum_d sin^2(pi |x_d - z_d| / p) / l^2)``; scikit-learn's
    ``ExpSineSquared`` for 1-D inputs.

    :param lengthscale: scalar correlation lengthscale ``l``.
    :param period: scalar period ``p``.
    :param variance: output variance.
    """

    def __init__(self, lengthscale=1.0, period=1.0, variance=1.0):
        self.lengthscale = lengthscale
        self.period = period
        self.variance = variance

    def __call__(self, x, z):
        diff = x[..., :, None, :] - z[..., None, :, :]  # [n, m, d]
        sine = torch.sin(
            math.pi * torch.abs(diff) / _param(self.period, x)
        ) / _param(self.lengthscale, x)
        return _param(self.variance, x) * torch.exp(
            -2.0 * torch.sum(sine * sine, dim=-1))

    def kdiag(self, x):
        return _param(self.variance, x).expand(x.shape[:-1])


class RationalQuadratic(_Stationary):
    """Rational quadratic ``v (1 + r^2 / (2 a))^{-a}``: a scale mixture of
    RBFs (scikit-learn's ``RationalQuadratic``).

    :param alpha: positive mixture index.
    """

    def __init__(self, lengthscale=1.0, variance=1.0, alpha=1.0):
        super().__init__(lengthscale, variance)
        self.alpha = alpha

    def __call__(self, x, z):
        a = _param(self.alpha, x)
        return _param(self.variance, x) * torch.pow(
            1.0 + self._r2(x, z) / (2.0 * a), -a)


class Linear(_Kernel):
    """Dot-product kernel ``v * (x - c) (z - c)'``."""

    def __init__(self, variance=1.0, center=0.0):
        self.variance = variance
        self.center = center

    def __call__(self, x, z):
        c = _param(self.center, x)
        return _param(self.variance, x) * ((x - c) @ (z - c).T)

    def kdiag(self, x):
        c = _param(self.center, x)
        return _param(self.variance, x) * torch.sum((x - c) ** 2, dim=-1)


class Constant(_Kernel):
    """Constant kernel ``k(x, z) = v`` (a bias term under :class:`Sum`)."""

    def __init__(self, variance=1.0):
        self.variance = variance

    def __call__(self, x, z):
        return _param(self.variance, x).expand((x.shape[0], z.shape[0]))

    def kdiag(self, x):
        return _param(self.variance, x).expand(x.shape[:-1])


class Sum(_Kernel):
    """``k1 + k2``."""

    def __init__(self, k1, k2):
        self.k1, self.k2 = k1, k2

    def __call__(self, x, z):
        return self.k1(x, z) + self.k2(x, z)

    def kdiag(self, x):
        return self.k1.kdiag(x) + self.k2.kdiag(x)


class Product(_Kernel):
    """``k1 * k2``."""

    def __init__(self, k1, k2):
        self.k1, self.k2 = k1, k2

    def __call__(self, x, z):
        return self.k1(x, z) * self.k2(x, z)

    def kdiag(self, x):
        return self.k1.kdiag(x) * self.k2.kdiag(x)


class GPPosterior(NamedTuple):
    """Predictive posterior from :func:`gp_regression`,
    :func:`sgpr_predict` and :func:`svgp_predict`."""

    mean: torch.Tensor  # [m] predictive mean at x_star
    var: torch.Tensor  # [m] marginal variance (or the [m, m] covariance)
    log_marginal: torch.Tensor  # scalar log p(y | X, theta) (or a bound)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol_jitter(K, jitter):
    return torch.linalg.cholesky(K + jitter * _eye(K.shape[-1], K))


def _log_2pi(like):
    return torch.log(2.0 * torch.tensor(math.pi, dtype=like.dtype,
                                        device=like.device))


def _as_tensors(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def gp_log_marginal(kernel, x, y, noise_var, jitter: float = 1e-6):
    """Exact log-marginal likelihood ``log N(y; 0, K + sigma^2 I)``,
    differentiable in the kernel hyperparameters and ``noise_var`` (type-II
    maximum likelihood is a gradient step on it).

    :param x: ``[n, d]`` inputs. :param y: ``[n]`` zero-mean targets.
    :param noise_var: observation noise variance ``sigma^2``.
    """
    x, y = _as_tensors(x, y)
    n = x.shape[0]
    K = kernel(x, x) + _param(noise_var, x) * _eye(n, x)
    L = _chol_jitter(K, jitter)
    a = _solve_lower(L, y)
    return (-0.5 * torch.sum(a * a)
            - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * _log_2pi(x))


def gp_regression(kernel, x, y, x_star, noise_var, full_cov: bool = False,
                  jitter: float = 1e-6) -> GPPosterior:
    """Exact GP regression posterior at ``x_star``: one Cholesky of
    ``K + sigma^2 I`` shared by the mean, the (co)variance and the
    log-marginal. The variances are the latent ``f*``'s (add ``noise_var``
    for ``y``); ``full_cov=True`` returns the ``[m, m]`` covariance."""
    x, y, x_star = _as_tensors(x, y, x_star)
    n = x.shape[0]
    K = kernel(x, x) + _param(noise_var, x) * _eye(n, x)
    L = _chol_jitter(K, jitter)
    Ks = kernel(x, x_star)  # [n, m]
    a = _solve_lower(L, y)
    V = _solve_lower(L, Ks)  # [n, m]
    mean = V.T @ a
    lm = (-0.5 * torch.sum(a * a)
          - torch.sum(torch.log(torch.diagonal(L)))
          - 0.5 * n * _log_2pi(x))
    if full_cov:
        cov = kernel(x_star, x_star) - V.T @ V
        return GPPosterior(mean=mean, var=cov, log_marginal=lm)
    var = kernel.kdiag(x_star) - torch.sum(V * V, dim=0)
    return GPPosterior(mean=mean, var=_max0(var), log_marginal=lm)


def _sgpr_core(kernel, x, y, z, sigma2, jitter):
    """The factorization the collapsed bound and its predictions share:
    ``(Lz, A, Lb, c)``."""
    m = z.shape[0]
    Lz = _chol_jitter(kernel(z, z), jitter)
    A = _solve_lower(Lz, kernel(z, x))  # [m, n]
    # B = I + A A' / sigma2: the m x m core of the Woodbury identity.
    B = _eye(m, x) + (A @ A.T) / sigma2
    Lb = torch.linalg.cholesky(B)
    c = _solve_lower(Lb, A @ y) / sigma2
    return Lz, A, Lb, c


def _sgpr_bound(kernel, x, y, A, Lb, c, sigma2):
    n = x.shape[0]
    log_det = (2.0 * torch.sum(torch.log(torch.diagonal(Lb)))
               + n * torch.log(sigma2))
    quad = torch.sum(y * y) / sigma2 - torch.sum(c * c)
    trace_term = (torch.sum(kernel.kdiag(x)) - torch.sum(A * A)) / sigma2
    return (-0.5 * (log_det + quad + n * _log_2pi(x))
            - 0.5 * trace_term)


def sgpr_elbo(kernel, x, y, z, noise_var, jitter: float = 1e-6):
    """Collapsed sparse-GP lower bound (Titsias 2009, eq. 9):
    ``log N(y; 0, Q_nn + sigma^2 I) - tr(K_nn - Q_nn) / (2 sigma^2)`` with
    ``Q_nn = K_nz K_zz^{-1} K_zn``; differentiable in the hyperparameters,
    the noise and the inducing inputs ``z``. O(n m^2); no ``[n, n]``
    matrix is formed."""
    x, y, z = _as_tensors(x, y, z)
    sigma2 = _param(noise_var, x)
    _, A, Lb, c = _sgpr_core(kernel, x, y, z, sigma2, jitter)
    return _sgpr_bound(kernel, x, y, A, Lb, c, sigma2)


def sgpr_predict(kernel, x, y, z, x_star, noise_var,
                 jitter: float = 1e-6) -> GPPosterior:
    """Predictive posterior of the collapsed sparse GP at ``x_star``
    through the optimal ``q(u)``, O(n m^2); ``log_marginal`` holds the
    bound, assembled from the same factorization."""
    x, y, z, x_star = _as_tensors(x, y, z, x_star)
    sigma2 = _param(noise_var, x)
    Lz, A, Lb, c = _sgpr_core(kernel, x, y, z, sigma2, jitter)
    As = _solve_lower(Lz, kernel(z, x_star))  # [m, s]
    tmp = _solve_lower(Lb, As)  # [m, s]
    mean = tmp.T @ c
    var = (kernel.kdiag(x_star) - torch.sum(As * As, dim=0)
           + torch.sum(tmp * tmp, dim=0))
    elbo = _sgpr_bound(kernel, x, y, A, Lb, c, sigma2)
    return GPPosterior(mean=mean, var=_max0(var), log_marginal=elbo)


# --------------------------------------------------------------------- #
# Uncollapsed sparse variational GP (Hensman et al. 2013, 2015). The data
# term is a sum over points: on a minibatch scaled by n_data / batch it is
# an unbiased estimate of the full bound.
# --------------------------------------------------------------------- #
class GaussianLikelihood(NamedTuple):
    """``p(y | f) = N(y; f, noise_var)``; closed-form expectation."""

    noise_var: torch.Tensor

    def variational_expectations(self, y, fmean, fvar):
        s2 = _param(self.noise_var, fmean)
        return (-0.5 * torch.log(2.0 * math.pi * s2)
                - ((y - fmean) ** 2 + fvar) / (2.0 * s2))

    def predict(self, fmean, fvar):
        """Predictive mean and variance of ``y`` under
        ``q(f) = N(fmean, fvar)``."""
        return fmean, fvar + _param(self.noise_var, fmean)


class BernoulliLikelihood(NamedTuple):
    """``p(y = 1 | f) = sigmoid(f)``, ``y`` in {0, 1}; expectations by
    Gauss-Hermite quadrature on ``n_quad`` nodes."""

    n_quad: int = 20

    def variational_expectations(self, y, fmean, fvar):
        # sign +1 for y = 1, -1 for y = 0: log p = -softplus(-sign * f).
        sign = torch.where(torch.as_tensor(y) > 0.5, 1.0, -1.0).to(
            fmean.dtype)[..., None]

        def logp(f):
            return -_softplus(-sign * f)

        return _gauss_hermite(logp, fmean, fvar, self.n_quad)

    def predict(self, fmean, fvar):
        p = _gauss_hermite(torch.sigmoid, fmean, fvar, self.n_quad)
        return p, p * (1.0 - p)


class PoissonLikelihood(NamedTuple):
    """``p(y | f) = Poisson(exp(f))``; closed form through
    ``E[exp(f)] = exp(mu + var / 2)``."""

    def variational_expectations(self, y, fmean, fvar):
        y = torch.as_tensor(y, dtype=fmean.dtype, device=fmean.device)
        return (y * fmean - torch.exp(fmean + 0.5 * fvar)
                - torch.lgamma(y + 1.0))

    def predict(self, fmean, fvar):
        mean = torch.exp(fmean + 0.5 * fvar)
        var = mean + (torch.exp(fvar) - 1.0) * mean ** 2
        return mean, var


def _gauss_hermite(g, mu, var, n_quad):
    """``E_{N(mu, var)}[g(f)]`` by Gauss-Hermite quadrature over the
    leading axes of ``mu`` / ``var``; the nodes are numpy's
    ``hermegauss`` (weight ``exp(-x^2 / 2)``), so ``E[g] = sum_i w_i
    g(mu + sqrt(var) x_i) / sqrt(2 pi)``."""
    xs, ws = np.polynomial.hermite_e.hermegauss(int(n_quad))
    xs = torch.as_tensor(xs, dtype=mu.dtype, device=mu.device)
    ws = torch.as_tensor(ws / np.sqrt(2.0 * np.pi), dtype=mu.dtype,
                         device=mu.device)
    f = mu[..., None] + torch.sqrt(_max0(var))[..., None] * xs
    return torch.sum(g(f) * ws, dim=-1)


class SVGPState(NamedTuple):
    """Variational state of the whitened SVGP: ``q(v) = N(q_mu, S)`` with
    ``S = tril(q_sqrt) tril(q_sqrt)'`` and ``u = chol(Kzz) v``; optimize
    its tensors beside the kernel hyperparameters."""

    z: torch.Tensor  # [m, d] inducing inputs
    q_mu: torch.Tensor  # [m]
    q_sqrt: torch.Tensor  # [m, m]; the lower triangle is used


def svgp_init(z, jitter_scale: float = 1.0) -> SVGPState:
    """The initial :class:`SVGPState` at inducing inputs ``z``:
    ``q(v) = N(0, I)`` (times ``jitter_scale`` on the factor), the
    prior."""
    z = torch.as_tensor(z)
    m = z.shape[0]
    return SVGPState(z=z, q_mu=torch.zeros((m,), dtype=z.dtype,
                                           device=z.device),
                     q_sqrt=jitter_scale * _eye(m, z))


def _svgp_common(kernel, state, x, jitter):
    z = state.z
    Lz = _chol_jitter(kernel(z, z), jitter)
    A = _solve_lower(Lz, kernel(z, x))  # [m, n]
    q_sqrt = torch.tril(state.q_sqrt)
    fmean = A.T @ state.q_mu
    SA = q_sqrt.T @ A  # [m, n]
    fvar = (kernel.kdiag(x) - torch.sum(A * A, dim=0)
            + torch.sum(SA * SA, dim=0))
    return fmean, _max0(fvar), q_sqrt


def svgp_marginals(kernel, state, x, jitter: float = 1e-6):
    """``[n]`` mean and variance of ``q(f(x))`` under the whitened SVGP
    posterior."""
    fmean, fvar, _ = _svgp_common(kernel, state, torch.as_tensor(x), jitter)
    return fmean, fvar


def _kl_whitened(q_mu, q_sqrt):
    """KL(N(m, LL') || N(0, I)), L = tril(q_sqrt)."""
    m = q_mu.shape[0]
    diag = torch.diagonal(q_sqrt)
    return 0.5 * (torch.sum(q_sqrt * q_sqrt) + torch.sum(q_mu * q_mu)
                  - m - 2.0 * torch.sum(torch.log(torch.abs(diag) + 1e-300)))


def svgp_elbo(kernel, state, x, y, likelihood, n_data: Optional[int] = None,
              jitter: float = 1e-6):
    """Uncollapsed SVGP bound (Hensman et al. 2013):
    ``N / |B| sum_{i in B} E_q(f_i)[log p(y_i | f_i)] - KL(q(v) || N(0,
    I))``, for any likelihood with ``variational_expectations``; pass
    ``n_data`` when ``(x, y)`` is a minibatch."""
    x, y = _as_tensors(x, y)
    fmean, fvar, q_sqrt = _svgp_common(kernel, state, x, jitter)
    ve = likelihood.variational_expectations(y, fmean, fvar)
    scale = 1.0 if n_data is None else n_data / x.shape[0]
    return scale * torch.sum(ve) - _kl_whitened(state.q_mu, q_sqrt)


def svgp_predict(kernel, state, x_star, likelihood=None,
                 jitter: float = 1e-6) -> GPPosterior:
    """Predictive posterior at ``x_star``: the latent marginals, through
    ``likelihood.predict`` when one is given (class probabilities for
    :class:`BernoulliLikelihood`). ``log_marginal`` is NaN: the
    uncollapsed bound needs targets (:func:`svgp_elbo`)."""
    fmean, fvar = svgp_marginals(kernel, state, x_star, jitter)
    if likelihood is not None:
        fmean, fvar = likelihood.predict(fmean, fvar)
    return GPPosterior(mean=fmean, var=fvar,
                       log_marginal=torch.tensor(float("nan"),
                                                 dtype=fmean.dtype,
                                                 device=fmean.device))


def svgp_state_from_numpy(numpy_state, device=None, dtype=None,
                          requires_grad=True) -> SVGPState:
    """A port :class:`SVGPState` from a JAX ``SVGPState`` whose leaves went
    through ``np.asarray`` (any object with the fields ``z``, ``q_mu``,
    ``q_sqrt``), on ``device`` (the card when None) in ``dtype`` (the
    arrays' own when None), leaves that require grad unless
    ``requires_grad`` is False."""
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)
    return SVGPState(*(
        torch.tensor(np.array(getattr(numpy_state, f)), dtype=dtype,
                     device=device).requires_grad_(requires_grad)
        for f in SVGPState._fields))


def svgp_state_to_numpy(state: SVGPState) -> SVGPState:
    """The state with numpy leaves, ready for
    ``zhusuan_tpu.gp.SVGPState(*...)``."""
    return SVGPState(*(v.detach().cpu().numpy() for v in state))
