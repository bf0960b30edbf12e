"""Stochastic-gradient MCMC: SGLD, PSGLD, SGHMC, SGNHT (port of
``zhusuan_tpu/mcmc/sgmcmc.py``).

Capability parity with reference ``zhusuan/sgmcmc.py``: the
``SGMCMC.sample`` contract (sgmcmc.py:119-161), SGLD (Welling & Teh 2011,
Eq. 3), PSGLD with the RMSprop preconditioner (Li et al. 2015, Eq. 4-5),
SGHMC (Chen et al. 2014, Eq. 15) with the optional second-order symmetric
splitting integrator (Chen et al. 2015), and SGNHT (Ding et al. 2014,
Alg. 2) with a scalar or per-coordinate thermostat.

One iteration is ``sample(state, key) -> (state, info)`` on the explicit
:class:`SGMCMCState`; ``run`` is a Python loop over it. ``state.t`` is a
host int, so the learning-rate schedule (a callable is evaluated at the
host ``t``), the momentum-resample test ``t % n_iter_resample_v == 0`` and
the random-number counter never read the device.

On a CUDA device, a single ``[n_chains, dim]`` float32 latent under a
built-in density (:mod:`~zhusuan_tpu_torch.ops.densities`) takes the
sampler's hand-written CUDA kernel for the whole update
(:mod:`~zhusuan_tpu_torch.ops.sgld_step`, ``psgld_step``, ``sghmc_step``,
``sgnht_step``; SGNHT with the vector thermostat only). Everything else
takes the plain torch path, whose transitions (:func:`sgld_transition`,
:func:`psgld_transition`, :func:`sghmc_transition`,
:func:`sgnht_transition`) the kernels' plain versions share.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

from zhusuan_tpu_torch.mcmc.base import (
    make_grad_fn,
    make_log_joint_fn,
    tree_normal_like,
)
from zhusuan_tpu_torch.mcmc.hmc import (
    _as_key,
    builtin_density_ineligible,
    use_kernel,
)
from zhusuan_tpu_torch.ops._random import iteration_generator
from zhusuan_tpu_torch.ops.hmc_step import MAX_DIM
from zhusuan_tpu_torch.ops.psgld_step import fused_psgld_step
from zhusuan_tpu_torch.ops.sghmc_step import fused_sghmc_step
from zhusuan_tpu_torch.ops.sgld_step import (
    DENSITIES,
    fused_sgld_step,
    sgld_step_supported,
)
from zhusuan_tpu_torch.ops.sgnht_step import fused_sgnht_step

__all__ = ["SGMCMC", "SGMCMCState", "SGMCMCInfo", "SGLD", "PSGLD", "SGHMC",
           "SGNHT", "learning_rate_tensor", "psgld_transition",
           "resample_momentum", "sghmc_transition", "sgld_transition",
           "sgnht_transition"]

Latent = Dict[str, torch.Tensor]


class SGMCMCState(NamedTuple):
    """Explicit sampler state. Unused auxiliary fields are empty dicts;
    ``t`` is a host int."""

    q: Latent
    t: int
    v: Latent  # momentum (SGHMC, SGNHT)
    alpha: Latent  # thermostat (SGNHT)
    rms: Latent  # RMSprop accumulator (PSGLD)


class SGMCMCInfo(NamedTuple):
    """Per-iteration statistics (parity: reference ``SGMCMCInfo``,
    sgmcmc.py:102-117; fields are dicts keyed by latent name)."""

    q: Latent
    mean_k: Optional[Dict[str, torch.Tensor]] = None
    alpha: Optional[Dict[str, torch.Tensor]] = None


# ---------------------------------------------------------------------- #
# The plain transitions, shared by the samplers' plain paths and the
# kernels' plain versions (ops/*_step.py::fused_*_step_reference). Every
# scalar is pinned to the state's dtype (``lr`` a 0-d tensor of it, the
# constants rounded to it), and each expression keeps the JAX package's
# order of operations, which the CUDA kernels follow too.
# ---------------------------------------------------------------------- #
def learning_rate_tensor(lr, dtype, device) -> torch.Tensor:
    """The learning rate as a 0-d tensor of ``dtype`` on ``device``,
    without a host sync: a number is filled in on the device, a tensor on
    the host is read there, a tensor on the device is cast there."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError("the learning rate must be a number or a "
                             "one-element tensor; got shape {}.".format(
                                 tuple(lr.shape)))
        if lr.device.type == "cpu" and torch.device(device).type != "cpu":
            lr = float(lr)
        else:
            return lr.to(device=device, dtype=dtype).reshape(())
    return torch.full((), float(lr), dtype=dtype, device=device)


def _round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def _cast(eps: Latent, like: Latent) -> Latent:
    return {k: eps[k].to(like[k].dtype) for k in like}


def sgld_transition(q: Latent, lr, grad_fn, eps: Latent) -> Latent:
    """SGLD (reference sgmcmc.py:195-200):
    ``q + 0.5 lr grad(q) + sqrt(lr) eps``."""
    grads = grad_fn(q)
    eps = _cast(eps, q)
    half, sq = 0.5 * lr, torch.sqrt(lr)
    return {k: q[k] + half * grads[k] + sq * eps[k] for k in q}


def psgld_transition(q: Latent, rms: Latent, lr, decay: float,
                     epsilon: float, grad_fn, eps: Latent):
    """PSGLD (reference sgmcmc.py:219-257): ``rms' = decay rms +
    (1 - decay) g^2``, ``G = 1 / (epsilon + sqrt(rms'))``,
    ``q' = q + 0.5 lr G g + sqrt(lr G) eps``. Returns ``(q', rms')``."""
    grads = grad_fn(q)
    eps = _cast(eps, q)
    half = 0.5 * lr
    new_q, new_rms = {}, {}
    for k in q:
        g = grads[k]
        new_rms[k] = decay * rms[k] + (1 - decay) * (g * g)
        precond = torch.reciprocal(epsilon + torch.sqrt(new_rms[k]))
        new_q[k] = (q[k] + half * precond * g
                    + torch.sqrt(lr * precond) * eps[k])
    return new_q, new_rms


def resample_momentum(lr, eps: Latent, like: Latent) -> Latent:
    """A fresh momentum ``sqrt(lr) eps`` for every latent of ``like``
    (reference sgmcmc.py:326-337)."""
    sq = torch.sqrt(lr)
    return {k: sq * e for k, e in _cast(eps, like).items()}


def sghmc_transition(q: Latent, v: Latent, lr, alpha: float, beta: float,
                     second_order: bool, grad_fn, eps: Latent):
    """SGHMC (reference sgmcmc.py:343-357) with noise
    ``sqrt(max(2 (alpha - beta) lr, 0)) eps``; first order
    ``v' = (1 - alpha) v + lr g(q) + noise, q' = q + v'``; second order
    ``q1 = q + v/2, v' = e (e v + lr g(q1) + noise), q' = q1 + v'/2`` with
    ``e = exp(-alpha/2)``. Returns ``(q', v')``."""
    eps = _cast(eps, q)
    sd = torch.sqrt(torch.clamp(2 * (alpha - beta) * lr, min=0.0))
    noise = {k: sd * eps[k] for k in q}
    if not second_order:
        grads = grad_fn(q)
        new_v = {k: (1 - alpha) * v[k] + lr * grads[k] + noise[k]
                 for k in q}
        return {k: q[k] + new_v[k] for k in q}, new_v
    decay_half = _round_to(math.exp(-0.5 * alpha), lr.dtype)
    q1 = {k: q[k] + 0.5 * v[k] for k in q}
    grads = grad_fn(q1)
    new_v = {k: decay_half * (decay_half * v[k] + lr * grads[k] + noise[k])
             for k in q}
    return {k: q1[k] + 0.5 * new_v[k] for k in q}, new_v


def sgnht_transition(q: Latent, v: Latent, alpha: Latent, lr, a: float,
                     tune_rate: float, second_order: bool,
                     vector_alpha: bool, grad_fn, eps: Latent):
    """SGNHT (reference sgmcmc.py:460-505) with noise ``sqrt(2 a lr) eps``
    and a per-coordinate (``vector_alpha``) or scalar thermostat; the
    scalar one reduces ``mean(v^2)`` over every chain and dimension.
    Returns ``(q', v', alpha', mean_k)``."""
    eps = _cast(eps, q)
    sd = torch.sqrt(2 * a * lr)
    noise = {k: sd * eps[k] for k in q}

    def reduce(x):
        return x if vector_alpha else torch.mean(x)

    if not second_order:
        grads = grad_fn(q)
        new_v = {k: (1 - alpha[k]) * v[k] + lr * grads[k] + noise[k]
                 for k in q}
        new_q = {k: q[k] + new_v[k] for k in q}
        mean_k = {k: reduce(new_v[k] * new_v[k]) for k in q}
        new_alpha = {k: alpha[k] + tune_rate * (mean_k[k] - lr) for k in q}
        return new_q, new_v, new_alpha, mean_k
    half_tune = 0.5 * tune_rate
    q1 = {k: q[k] + 0.5 * v[k] for k in q}
    alpha1 = {k: alpha[k] + half_tune * (reduce(v[k] * v[k]) - lr)
              for k in q}
    decay_half = {k: torch.exp(-0.5 * alpha1[k]) for k in q}
    grads = grad_fn(q1)
    new_v = {k: decay_half[k] * (decay_half[k] * v[k] + lr * grads[k]
                                 + noise[k]) for k in q}
    new_q = {k: q1[k] + 0.5 * new_v[k] for k in q}
    mean_k = {k: reduce(new_v[k] * new_v[k]) for k in q}
    new_alpha = {k: alpha1[k] + half_tune * (mean_k[k] - lr) for k in q}
    return new_q, new_v, new_alpha, mean_k


# ---------------------------------------------------------------------- #
def _state_dtype(q: Latent):
    """The dtype the scalars are pinned to: the latents' promoted dtype,
    float32 for a half-precision state."""
    dtype = q[next(iter(q))].dtype
    for x in q.values():
        dtype = torch.promote_types(dtype, x.dtype)
    return dtype if dtype == torch.float64 else torch.float32


def _as_latent(value, q: Latent) -> Latent:
    """A tensor for a single latent as ``{name: tensor}``; dicts as
    given."""
    if value is None or not isinstance(value, torch.Tensor):
        return value
    (name,) = q
    return {name: value}


class SGMCMC:
    """Base class: the shared ``init`` / ``sample`` / ``run`` loop.

    Subclasses implement ``_init_aux(q, dtype, key, noise)`` and
    ``_update(step) -> (new_state, info)``.

    ``noise=`` of :meth:`sample` is a testing hook that replaces the
    draws: for SGLD and PSGLD the integrator's standard normals (shaped
    like the latent: a dict, or a tensor for a single latent); for SGHMC
    and SGNHT a pair ``(eps, eps_v)`` of those and of the normals of the
    momentum resample (used only on an iteration that resamples).
    """

    def _set_fused(self, experimental_fused_step):
        if experimental_fused_step not in (True, False, "auto"):
            raise ValueError(
                "experimental_fused_step must be True, False, or 'auto'.")
        self.experimental_fused_step = experimental_fused_step

    def _lr(self, t: int):
        """The learning rate of iteration ``t``: a callable schedule is
        evaluated at the host int ``t``."""
        lr = self.learning_rate
        return lr(t) if callable(lr) else lr

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init(self, latent: Latent, key=None, *, noise=None) -> SGMCMCState:
        """The initial state at positions ``latent``. Samplers with
        momentum (SGHMC, SGNHT) need a ``key`` (a ``(k0, k1)`` pair or a
        ``torch.Generator``) to draw it, ``v = sqrt(lr(0)) N(0, 1)``;
        ``noise`` (standard normals shaped like the latent) replaces the
        draw (testing hook)."""
        q = {k: torch.as_tensor(v) for k, v in latent.items()}
        return self._init_aux(q, _state_dtype(q), key,
                              _as_latent(noise, q))

    def _init_aux(self, q, dtype, key, noise):
        return SGMCMCState(q=q, t=0, v={}, alpha={}, rms={})

    def _init_momentum(self, q, dtype, key, noise) -> Latent:
        if key is None and noise is None:
            raise ValueError("{}.init requires a key (momentum init)."
                             .format(type(self).__name__))
        x0 = q[next(iter(q))]
        gen = (None if noise is not None
               else iteration_generator(_as_key(key), 0, x0.device))
        lr0 = learning_rate_tensor(self._lr(0), dtype, x0.device)
        return resample_momentum(lr0, tree_normal_like(gen, q, noise), q)

    # ------------------------------------------------------------------ #
    def _fused_ineligible(self, log_joint, observed, q, lr):
        """Why the kernel cannot take this update (None if it can)."""
        if isinstance(lr, torch.Tensor) and lr.numel() != 1:
            return "the learning rate must be a number or a one-element tensor"
        return builtin_density_ineligible(
            log_joint, observed, q, None, 1, sgld_step_supported, DENSITIES,
            "float32 with dim <= {}".format(MAX_DIM))

    def _use_kernel(self, log_joint, observed, q, lr) -> bool:
        return use_kernel(self.experimental_fused_step, q,
                          lambda: self._fused_ineligible(log_joint, observed,
                                                         q, lr))

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def sample(self, log_joint, observed, state: SGMCMCState, key=None, *,
               noise=None):
        """One SGMCMC iteration: ``(state, key) -> (state, info)``.

        Parity: the ``sample(meta_bn, observed, latent)`` contract of
        reference sgmcmc.py:119-161, with the latents in ``state.q``.

        :param log_joint: ``log_joint(obs_dict)`` callable, e.g. a built-in
            density of :mod:`~zhusuan_tpu_torch.ops.densities`.
        :param observed: dict of observations.
        :param key: key ``(k0, k1)`` or a ``torch.Generator`` to draw one
            from. The draws of iteration ``t`` depend only on the key and
            ``t``, so one key serves a whole run.
        :param noise: testing hook replacing the draws (see the class
            docstring).
        :return: ``(new_state, SGMCMCInfo)``.
        """
        # With injected noise and no key, the kernel's Philox is unused.
        key = None if noise is not None and key is None else _as_key(key)
        step = _Step(self, log_joint, observed, state, key, noise)
        return self._update(step)

    # ------------------------------------------------------------------ #
    def run(self, log_joint, observed, state: SGMCMCState, key,
            n_iters: int, collect: bool = True, thinning: int = 1,
            collect_info: bool = False):
        """Run ``n_iters`` iterations in a Python loop over :meth:`sample`.

        The key is drawn once, here, from ``key`` (a ``torch.Generator`` or
        a ``(k0, k1)`` pair); each iteration's draws follow from it and the
        host-int ``state.t``, so a thinned run's final state equals the
        unthinned run's bit for bit. Outputs go into preallocated buffers.

        :param collect: stack per-iteration ``q`` (thinned) when True.
        :param thinning: with ``collect``, stack every ``thinning``-th
            iteration only: ``n_iters // thinning`` rows, the trajectory
            sliced ``thinning-1::thinning``.
        :param collect_info: also stack the per-iteration
            :class:`SGMCMCInfo` (thinned like ``q`` when ``collect``).
        :return: ``(final_state, stacked_q_or_None)``, or
            ``(final_state, stacked_q_or_None, stacked_info)`` when
            ``collect_info``.
        """
        if int(thinning) < 1:
            raise ValueError("thinning must be >= 1.")
        key = _as_key(key)
        n_iters = int(n_iters)
        thin = int(thinning) if collect else 1
        keep = collect or collect_info
        n_out = n_iters // thin if keep else 0
        bufs = {}

        def store(row, info):
            for field in ("q", "mean_k", "alpha"):
                value = getattr(info, field)
                if value is None or (field != "q" and not collect_info):
                    continue
                buf = bufs.setdefault(field, {})
                for n, x in value.items():
                    if n not in buf:
                        buf[n] = x.new_empty((n_out,) + tuple(x.shape))
                    buf[n][row].copy_(x)

        for i in range(n_iters):
            state, info = self.sample(log_joint, observed, state, key)
            row, hit = divmod(i + 1, thin)
            if keep and hit == 0 and row <= n_out:
                store(row - 1, info)
        qs = bufs.get("q") if collect else None
        if collect_info:
            return state, qs, SGMCMCInfo(q=bufs.get("q"),
                                         mean_k=bufs.get("mean_k"),
                                         alpha=bufs.get("alpha"))
        return state, qs


class _Step:
    """What one :meth:`SGMCMC.sample` call works on."""

    def __init__(self, sampler, log_joint, observed, state, key, noise):
        self.log_joint = log_joint
        self.observed = observed
        self.state = state
        self.key = key
        self.noise = noise
        self.new_t = state.t + 1
        self.lr = sampler._lr(state.t)
        self.grad_fn = make_grad_fn(make_log_joint_fn(log_joint, observed))
        q = state.q
        self.x0 = q[next(iter(q))]
        self.dtype = _state_dtype(q)
        self.kernel = sampler._use_kernel(log_joint, observed, q, self.lr)
        # The plain path's learning rate, pinned to the state's dtype.
        self.lr_tensor = (None if self.kernel else learning_rate_tensor(
            self.lr, self.dtype, self.x0.device))
        self._gen = None

    def normals(self, like: Latent, injected) -> Latent:
        """Standard normals shaped like ``like`` (the plain path's draws
        from the iteration's generator, or ``injected``)."""
        if injected is None and self._gen is None:
            self._gen = iteration_generator(self.key, self.new_t,
                                            self.x0.device)
        return tree_normal_like(self._gen, like, _as_latent(injected, like))

    def single(self):
        """``(name, tensor)`` of the kernel path's single latent."""
        ((name, x),) = self.state.q.items()
        return name, x


class SGLD(SGMCMC):
    """Stochastic Gradient Langevin Dynamics (Welling & Teh 2011, Eq. 3).

    Update (reference sgmcmc.py:195-200):
    ``q += 0.5*lr*grad + Normal(0, sqrt(lr))``.

    :param learning_rate: float, one-element tensor, or callable
        ``t -> lr`` evaluated at the host int ``t`` (decaying schedules).
    :param experimental_fused_step: ``"auto"`` (default) runs the whole
        update in the CUDA kernel
        (:func:`~zhusuan_tpu_torch.ops.sgld_step.fused_sgld_step`) whenever
        it is eligible (see the module docstring) and the plain path
        otherwise; ``False`` always takes the plain path; ``True`` requires
        the kernel for CUDA tensors and raises when they are not eligible.
        CPU tensors always take the plain path.
    """

    def __init__(self, learning_rate: Union[float, Callable],
                 experimental_fused_step="auto"):
        self.learning_rate = learning_rate
        self._set_fused(experimental_fused_step)

    def _update(self, step: _Step):
        state = step.state
        # A subclass that changes the update must not take SGLD's kernel.
        if step.kernel and type(self) is SGLD:
            name, x = step.single()
            new_q = {name: fused_sgld_step(
                step.log_joint, x, step.lr, step.key, step.new_t,
                noise=_pick(step.noise, name))}
        else:
            new_q = sgld_transition(state.q, step.lr_tensor, step.grad_fn,
                                    step.normals(state.q, step.noise))
        return (state._replace(q=new_q, t=step.new_t),
                SGMCMCInfo(q=new_q))


class PSGLD(SGLD):
    """Preconditioned SGLD with the RMSprop preconditioner (Li et al. 2015,
    Eq. 4-5; reference sgmcmc.py:203-257).

    Aux: ``rms = decay*rms + (1-decay)*grad**2``;
    ``G = 1/(epsilon + sqrt(rms))``;
    update ``q += 0.5*lr*G*grad + Normal(0, sqrt(lr*G))``.

    :param experimental_fused_step: as for :class:`SGLD`, with the kernel
        :func:`~zhusuan_tpu_torch.ops.psgld_step.fused_psgld_step`.
    """

    def __init__(self, learning_rate, decay: float = 0.9,
                 epsilon: float = 1e-3, experimental_fused_step="auto"):
        super().__init__(learning_rate,
                         experimental_fused_step=experimental_fused_step)
        self.decay = float(decay)
        self.epsilon = float(epsilon)

    def _init_aux(self, q, dtype, key, noise):
        rms = {k: torch.zeros_like(v) for k, v in q.items()}
        return SGMCMCState(q=q, t=0, v={}, alpha={}, rms=rms)

    def _update(self, step: _Step):
        state = step.state
        if step.kernel:
            name, x = step.single()
            q1, r1 = fused_psgld_step(
                step.log_joint, x, state.rms[name], step.lr, self.decay,
                self.epsilon, step.key, step.new_t,
                noise=_pick(step.noise, name))
            new_q, new_rms = {name: q1}, {name: r1}
        else:
            new_q, new_rms = psgld_transition(
                state.q, state.rms, step.lr_tensor, self.decay,
                self.epsilon, step.grad_fn,
                step.normals(state.q, step.noise))
        return (state._replace(q=new_q, t=step.new_t, rms=new_rms),
                SGMCMCInfo(q=new_q))


def _pick(noise, name):
    """The tensor of ``name`` in an injected-noise argument (a tensor or a
    dict), or None."""
    if noise is None or isinstance(noise, torch.Tensor):
        return noise
    return noise[name]


class _Momentum(SGMCMC):
    """The momentum samplers' shared resample rule (reference
    sgmcmc.py:326-337)."""

    def _init_aux(self, q, dtype, key, noise):
        v = self._init_momentum(q, dtype, key, noise)
        return SGMCMCState(q=q, t=0, v=v, alpha=self._init_alpha(q), rms={})

    def _init_alpha(self, q):
        return {}

    def _resamples(self, t: int) -> bool:
        """Whether iteration ``t`` (the state's counter before it) draws a
        fresh momentum: a host branch, never a device ``cond``."""
        return self.n_iter_resample_v > 0 and t % self.n_iter_resample_v == 0

    def _plain_momentum(self, step: _Step, resample: bool):
        """``(v, eps)`` of the plain path: the (resampled) momentum and the
        integrator's normals, drawn in that order."""
        eps, eps_v = (None, None) if step.noise is None else step.noise
        v = step.state.v
        if resample:
            if step.noise is not None and eps_v is None:
                raise ValueError("noise must hold the resample normals on "
                                 "an iteration that resamples the momentum.")
            v = resample_momentum(step.lr_tensor, step.normals(v, eps_v), v)
        return v, step.normals(v, eps)

    @staticmethod
    def _kernel_noise(step: _Step, name, resample: bool):
        if step.noise is None:
            return None
        eps, eps_v = step.noise
        return (_pick(eps, name), _pick(eps_v, name) if resample else None)


class SGHMC(_Momentum):
    """Stochastic Gradient HMC (Chen et al. 2014, Eq. 15) with an optional
    second-order symmetric splitting integrator (Chen et al. 2015).

    Parity: reference sgmcmc.py:260-371: momentum resampled every
    ``n_iter_resample_v`` iterations; noise stddev
    ``sqrt(2*(alpha-beta)*lr)``; first order
    ``v' = (1-alpha)*v + lr*grad(q) + noise; q' = q + v'``; second order
    ``q1 = q + v/2; v' = e^{-alpha/2}(e^{-alpha/2} v + lr*grad(q1) +
    noise); q' = q1 + v'/2``. Info carries each latent's mean kinetic
    energy ``mean(v'^2)``.

    :param learning_rate: eta in Eq. 15 (O(step^2)); a float, one-element
        tensor or callable of the host int ``t``.
    :param friction: alpha.
    :param variance_estimate: beta (must be < alpha).
    :param n_iter_resample_v: momentum resample period (0/None disables).
    :param second_order: use the second-order integrator.
    :param experimental_fused_step: as for :class:`SGLD`, with the kernel
        :func:`~zhusuan_tpu_torch.ops.sghmc_step.fused_sghmc_step`.
    """

    def __init__(self, learning_rate, friction: float = 0.25,
                 variance_estimate: float = 0.0,
                 n_iter_resample_v: Optional[int] = 20,
                 second_order: bool = True, experimental_fused_step="auto"):
        self.learning_rate = learning_rate
        self.alpha = float(friction)
        self.beta = float(variance_estimate)
        if not self.beta < self.alpha:
            raise ValueError(
                "variance_estimate (beta={}) must be < friction (alpha={}) "
                "— the injected noise variance 2*(alpha-beta)*lr must be "
                "positive.".format(self.beta, self.alpha)
            )
        self.n_iter_resample_v = int(n_iter_resample_v or 0)
        self.second_order = bool(second_order)
        self._set_fused(experimental_fused_step)

    def _update(self, step: _Step):
        state = step.state
        resample = self._resamples(state.t)
        if step.kernel:
            name, x = step.single()
            q1, v1, vsq = fused_sghmc_step(
                step.log_joint, x, state.v[name], step.lr, self.alpha,
                self.beta, self.second_order, step.key, step.new_t,
                resample=resample,
                noise=self._kernel_noise(step, name, resample))
            new_q, new_v = {name: q1}, {name: v1}
            mean_k = {name: torch.sum(vsq) / float(x.numel())}
        else:
            v, eps = self._plain_momentum(step, resample)
            new_q, new_v = sghmc_transition(
                state.q, v, step.lr_tensor, self.alpha, self.beta,
                self.second_order, step.grad_fn, eps)
            mean_k = {k: torch.mean(new_v[k] * new_v[k]) for k in state.q}
        return (state._replace(q=new_q, v=new_v, t=step.new_t),
                SGMCMCInfo(q=new_q, mean_k=mean_k))


class SGNHT(_Momentum):
    """Stochastic Gradient Nosé-Hoover Thermostat (Ding et al. 2014,
    Alg. 2) with auto-tuned friction, scalar or per-coordinate.

    Parity: reference sgmcmc.py:374-523: noise stddev ``sqrt(2*a*lr)``;
    first order ``v' = (1-alpha)*v + lr*grad + noise; q' = q + v';
    alpha' = alpha + tune_rate*(mean(v'^2) - lr)``; second order with
    half-step thermostat updates and ``exp(-alpha1/2)`` decay.

    :param use_vector_alpha: a thermostat per chain and coordinate when
        True (alpha has the latent's shape), one scalar otherwise (which
        reduces ``mean(v^2)`` over every chain and dimension, coupling the
        chains).
    :param experimental_fused_step: as for :class:`SGLD`, with the kernel
        :func:`~zhusuan_tpu_torch.ops.sgnht_step.fused_sgnht_step`, which
        runs the vector thermostat only.
    """

    def __init__(self, learning_rate, variance_extra: float = 0.0,
                 tune_rate: float = 1.0,
                 n_iter_resample_v: Optional[int] = None,
                 second_order: bool = True, use_vector_alpha: bool = True,
                 experimental_fused_step="auto"):
        self.learning_rate = learning_rate
        self.a = float(variance_extra)
        self.tune_rate = float(tune_rate)
        self.n_iter_resample_v = int(n_iter_resample_v or 0)
        self.second_order = bool(second_order)
        self.use_vector_alpha = bool(use_vector_alpha)
        self._set_fused(experimental_fused_step)

    def _init_alpha(self, q):
        if self.use_vector_alpha:
            return {k: self.a * torch.ones_like(x) for k, x in q.items()}
        return {k: torch.full((), self.a, dtype=x.dtype, device=x.device)
                for k, x in q.items()}

    def _fused_ineligible(self, log_joint, observed, q, lr):
        if not self.use_vector_alpha:
            return ("the scalar thermostat (use_vector_alpha=False) reduces "
                    "mean(v^2) over every chain and dimension, which couples "
                    "the chains; the kernel runs the vector thermostat only")
        return super()._fused_ineligible(log_joint, observed, q, lr)

    def _update(self, step: _Step):
        state = step.state
        resample = self._resamples(state.t)
        if step.kernel:
            name, x = step.single()
            q1, v1, a1 = fused_sgnht_step(
                step.log_joint, x, state.v[name], state.alpha[name], step.lr,
                self.a, self.tune_rate, self.second_order, step.key,
                step.new_t, resample=resample,
                noise=self._kernel_noise(step, name, resample))
            new_q, new_v, new_alpha = {name: q1}, {name: v1}, {name: a1}
            mean_k = {name: v1 * v1}
        else:
            v, eps = self._plain_momentum(step, resample)
            new_q, new_v, new_alpha, mean_k = sgnht_transition(
                state.q, v, state.alpha, step.lr_tensor, self.a,
                self.tune_rate, self.second_order, self.use_vector_alpha,
                step.grad_fn, eps)
        return (state._replace(q=new_q, v=new_v, alpha=new_alpha,
                               t=step.new_t),
                SGMCMCInfo(q=new_q, mean_k=mean_k, alpha=new_alpha))
