"""No-U-Turn Sampler with multinomial trajectory sampling (port of
``zhusuan_tpu/mcmc/nuts.py``).

Each iteration doubles a leapfrog trajectory in a random direction until
the generalized U-turn criterion (Betancourt 2017) or ``max_tree_depth``
stops it, and draws the next position multinomially from the visited
leaves, with biased progressive sampling toward the newer half. The
iterative formulation of the JAX package is kept: per-level U-turn checks
from a stack of checkpoints (slot ``popcount(i >> 1)`` for an even leaf
``i``; an odd leaf checks the top ``trailing_ones(i)`` slots).

The JAX scan path runs one transition per chain under ``vmap`` with
per-chain ``while_loop`` s. Torch cannot batch a data-dependent loop, so
:func:`nuts_transition` is written batched over chains with masks, the way
the Pallas kernels are: a Python loop over doublings and over the leaves of
each subtree, per-chain ``alive`` / ``turning`` / ``diverging`` masks, and
an early exit once no chain is still building (checked once per doubling
and every 64 leaves; each check is one host sync). The sampler's plain path
and the kernel's plain version
(:func:`~zhusuan_tpu_torch.ops.nuts_step.fused_nuts_transition_reference`)
both run it.

On a CUDA device, a log-joint that is one of the NUTS kernel's built-in
densities (:data:`~zhusuan_tpu_torch.ops.nuts_step.DENSITIES`) takes the
hand-written CUDA kernel
(:func:`~zhusuan_tpu_torch.ops.nuts_step.fused_nuts_transition`) for the
whole tree, at every depth from 1 to 12: the diagonal Gaussian over a
single ``[n_chains, dim]`` float32 latent, or a built-in over several
latents (:class:`~zhusuan_tpu_torch.ops.densities.LatentDictDensity`)
whose names are the latent dict's, each ``[n_chains]`` plus its shape in
float32, with no observed leaf but the data it holds. The latents are
raveled in sorted-name order, as the JAX package's NUTS gate flattens them
(``zhusuan_tpu/mcmc/nuts.py:534-572``). Everything else takes the plain
path. The state is the port's
:class:`~zhusuan_tpu_torch.mcmc.hmc.HMCState` (``t`` a host int), so
``state_from_numpy`` / ``state_to_numpy`` carry a JAX NUTS state
unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from zhusuan_tpu_torch.mcmc.base import (
    adapt_span,
    dual_averaging_update,
    make_log_joint_fn,
    run_driver,
)
from zhusuan_tpu_torch.mcmc.hmc import (
    HMCState,
    builtin_density_ineligible,
    init_state,
    mass_update,
    use_kernel,
)
from zhusuan_tpu_torch.ops._random import as_key, iteration_generator
from zhusuan_tpu_torch.ops.densities import BuiltinDensity, LatentDictDensity
from zhusuan_tpu_torch.ops.nuts_step import (
    DENSITIES,
    MAX_DIM,
    MAX_TREE_DEPTH,
    fused_nuts_transition,
    nuts_step_supported,
)
from zhusuan_tpu_torch.profiling import span

__all__ = ["NUTS", "NUTSInfo", "nuts_transition"]

Latent = Dict[str, torch.Tensor]

# Leaves between two checks for chains still building a subtree.
_LEAF_SYNC = 64


class NUTSInfo(NamedTuple):
    """Per-iteration statistics (the JAX package's ``NUTSInfo``)."""

    samples: Latent
    acceptance_rate: torch.Tensor  # mean leaf-acceptance statistic
    updated_step_size: torch.Tensor  # scalar
    log_prob: torch.Tensor  # log joint at the new position, per chain
    depth: torch.Tensor  # tree depth reached, per chain (int32)
    n_leapfrogs: torch.Tensor  # leapfrog steps taken, per chain (int32)
    divergent: torch.Tensor  # bool, per chain
    turning: torch.Tensor  # bool: ended by U-turn (vs max depth)
    energy: torch.Tensor  # Hamiltonian of the selected draw, per chain


class _Flattener:
    """Ravel a latent dict's data axes into one ``[dim]`` vector per chain
    (sorted-name order, the JAX package's reproducibility contract)."""

    def __init__(self, q: Latent, n_chain_dims: int):
        self.names = sorted(q)
        self.data_shapes = {k: tuple(q[k].shape[n_chain_dims:])
                            for k in self.names}
        self.sizes = {k: math.prod(self.data_shapes[k]) for k in self.names}
        self.dtypes = {k: q[k].dtype for k in self.names}
        dtype = q[self.names[0]].dtype
        for k in self.names:
            dtype = torch.promote_types(dtype, q[k].dtype)
        self.dtype = dtype
        self.dim = sum(self.sizes.values())

    def ravel(self, tree: Latent, lead_shape) -> torch.Tensor:
        """``lead_shape`` is the already-flattened leading shape (e.g.
        ``(C,)`` for chain-stacked input, ``()`` per chain)."""
        lead_shape = tuple(lead_shape)
        return torch.cat([
            tree[k].reshape(lead_shape + (self.sizes[k],)).to(self.dtype)
            for k in self.names], dim=-1)

    def unravel(self, flat: torch.Tensor, lead_shape) -> Latent:
        lead_shape = tuple(lead_shape)
        out, start = {}, 0
        for k in self.names:
            piece = flat[..., start:start + self.sizes[k]]
            out[k] = piece.reshape(lead_shape + self.data_shapes[k]).to(
                self.dtypes[k])
            start += self.sizes[k]
        return out


def _trailing_ones(i: int) -> int:
    """Number of trailing one-bits of ``i`` (= the count of complete
    binary subtrees ending at leaf ``i``)."""
    n = i + 1
    return ((n & -n) - 1).bit_count()


def value_and_grad(log_prob):
    """``vag(x) -> (log_prob(x), d sum(log_prob(x)) / dx)`` by autograd,
    for ``log_prob`` mapping ``[c, dim]`` to ``[c]`` (chains independent)."""

    def vag(x):
        with torch.enable_grad():
            leaf = x.detach().requires_grad_(True)
            lp = log_prob(leaf)
            if lp.requires_grad:
                (g,) = torch.autograd.grad(lp.sum(), leaf, allow_unused=True)
            else:
                g = None
        return lp.detach(), (g if g is not None else torch.zeros_like(x))

    return vag


def draw_noise(generator, n_chains: int, dim: int, max_tree_depth: int,
               dtype, device):
    """The transition's random numbers from ``generator``:
    ``(eps [c, dim] normals, u_dir [c, D], u_leaf [c, 2**D - 1],
    u_merge [c, D])`` uniforms in [0, 1)."""
    D = int(max_tree_depth)
    kw = dict(generator=generator, dtype=dtype, device=device)
    return (torch.randn(n_chains, dim, **kw),
            torch.rand(n_chains, D, **kw),
            torch.rand(n_chains, (1 << D) - 1, **kw),
            torch.rand(n_chains, D, **kw))


def _any_alive(mask) -> bool:
    """``bool(mask.any())``, a host read of the device: one
    ``zs.sync.nuts_tree`` span."""
    with span("zs.sync.nuts_tree"):
        return bool(mask.any())


def nuts_transition(vag, q0, inv_mass, step_size, max_tree_depth: int,
                    max_delta_energy: float, noise):
    """One NUTS transition for every chain, batched with masks.

    The JAX package's ``NUTS._transition_one`` and ``_build_subtree`` on
    all chains at once: same leapfrog, multinomial weights, U-turn
    criterion and divergence rule, and the same random numbers when they
    are given (``bernoulli`` is ``u_dir < 0.5``; leaf and merge selections
    compare ``log u``).

    :param vag: ``q [c, dim] -> (log_prob [c], grad [c, dim])``.
    :param q0: ``[c, dim]`` positions.
    :param inv_mass: ``[dim]`` inverse diagonal mass.
    :param step_size: scalar (float or tensor).
    :param noise: ``(eps [c, dim], u_dir [c, D], u_leaf [c, 2**D - 1],
        u_merge [c, D])``: standard normals of the momentum ``eps /
        sqrt(inv_mass)`` and uniforms of the direction of each doubling,
        the selection at each leaf (leaves numbered across the tree, the
        subtree of doubling ``k`` holding leaves ``2**k - 1 .. 2**(k+1) -
        2``) and the selection at each merge.
    :return: ``(q', log_prob, energy, accept_stat, depth, n_leapfrogs,
        turning, divergent)`` per chain; ``depth`` and ``n_leapfrogs``
        int32, ``turning`` and ``divergent`` bool.
    """
    D = int(max_tree_depth)
    dt = q0.dtype
    eps_n, u_dir, u_leaf, u_merge = noise
    step = torch.as_tensor(step_size, dtype=dt, device=q0.device)
    p0 = eps_n.to(dt) / torch.sqrt(inv_mass)
    lp0, g0 = vag(q0)
    h0 = -lp0 + 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    # Density-derived quantities live in the dtype of h0 (the promotion of
    # density and latent dtypes), as in the JAX package.
    ldt = h0.dtype
    lp0 = lp0.to(ldt)
    go_right = u_dir < 0.5
    log_u_leaf = torch.log(u_leaf.to(dt))
    log_u_merge = torch.log(u_merge.to(dt))
    neg_inf = torch.full_like(h0, -math.inf)
    zero = torch.zeros_like(h0)
    c = q0.shape[0]

    q_l = q_r = q0
    p_l = p_r = p0
    g_l = g_r = g0
    q_prop, lp_prop, h_prop = q0, lp0, h0
    logw, psum = -h0, p0
    alive = torch.ones(c, dtype=torch.bool, device=q0.device)
    turning = torch.zeros_like(alive)
    diverging = torch.zeros_like(alive)
    depth = torch.zeros(c, dtype=torch.int32, device=q0.device)
    n_leap = torch.zeros_like(depth)
    sum_alpha = torch.zeros_like(h0)
    n_slots = max(1, D - 1)  # popcount(i >> 1) < D - 1 for i < 2**(D-1)
    ckpt_p = q0.new_zeros((c, n_slots, q0.shape[1]))
    ckpt_psum = torch.zeros_like(ckpt_p)

    for k in range(D):
        if k and not _any_alive(alive):
            break
        right = go_right[:, k]
        r2 = right[:, None]
        eps_s = torch.where(r2, step, -step)
        qq = torch.where(r2, q_r, q_l)
        pp = torch.where(r2, p_r, p_l)
        gg = torch.where(r2, g_r, g_l)
        s_logw = neg_inf
        s_psum = torch.zeros_like(psum)
        s_turn = torch.zeros_like(alive)
        s_div = torch.zeros_like(alive)
        sq_prop, slp_prop, sh_prop = qq, zero, zero
        for i in range(1 << k):
            s_alive = alive & ~s_turn & ~s_div
            if i and i % _LEAF_SYNC == 0 and not _any_alive(s_alive):
                break
            sa = s_alive[:, None]
            # --- one leapfrog step (grad carried from the edge) -------- #
            p_half = pp + 0.5 * eps_s * gg
            q_new = qq + eps_s * p_half * inv_mass
            lp_new, g_new = vag(q_new)
            lp_new = lp_new.to(ldt)
            p_new = p_half + 0.5 * eps_s * g_new
            h = -lp_new + 0.5 * torch.sum(p_new * p_new * inv_mass, dim=-1)
            delta = h - h0
            nan = torch.isnan(delta)
            div = nan | (delta > max_delta_energy)
            alpha = torch.where(nan, zero,
                                torch.clamp(torch.exp(-delta), max=1.0))

            # --- progressive multinomial sampling within the subtree --- #
            w = torch.where(div, neg_inf, -h)
            s_logw_new = torch.logaddexp(s_logw, w)
            take = s_alive & (log_u_leaf[:, (1 << k) - 1 + i]
                              < w - s_logw_new)
            sq_prop = torch.where(take[:, None], q_new, sq_prop)
            slp_prop = torch.where(take, lp_new, slp_prop)
            sh_prop = torch.where(take, h, sh_prop)
            s_logw = torch.where(s_alive, s_logw_new, s_logw)

            # --- iterative U-turn bookkeeping -------------------------- #
            slot = (i >> 1).bit_count()
            if i % 2 == 0:
                # The left edge of the subtrees starting here: checkpoint
                # (momentum, psum before it) at its stack slot.
                store = (s_alive & ~div)[:, None]
                ckpt_p[:, slot] = torch.where(store, p_new, ckpt_p[:, slot])
                ckpt_psum[:, slot] = torch.where(store, s_psum,
                                                 ckpt_psum[:, slot])
            s_psum = torch.where(sa, s_psum + p_new, s_psum)
            if i % 2 == 1:
                # Every complete subtree ending here: the top
                # trailing_ones(i) checkpoints.
                lo = slot - _trailing_ones(i) + 1
                sub = s_psum[:, None, :] - ckpt_psum[:, lo:slot + 1]
                v_new = p_new * inv_mass
                turn = (
                    (torch.sum(sub * (ckpt_p[:, lo:slot + 1] * inv_mass),
                               dim=-1) <= 0.0)
                    | (torch.sum(sub * v_new[:, None, :], dim=-1) <= 0.0)
                ).any(dim=-1)
                s_turn = s_turn | (s_alive & ~div & turn)
            s_div = s_div | (s_alive & div)
            sum_alpha = sum_alpha + torch.where(s_alive, alpha, zero)
            n_leap = n_leap + s_alive.to(torch.int32)
            qq = torch.where(sa, q_new, qq)
            pp = torch.where(sa, p_new, pp)
            gg = torch.where(sa, g_new, gg)

        # --- doubling merge: biased progressive sampling toward the new
        # subtree, only when it is valid (Betancourt 2017) -------------- #
        stop = s_turn | s_div
        merge_ok = alive & ~stop
        take = merge_ok & (log_u_merge[:, k] < s_logw - logw)
        q_prop = torch.where(take[:, None], sq_prop, q_prop)
        lp_prop = torch.where(take, slp_prop, lp_prop)
        h_prop = torch.where(take, sh_prop, h_prop)
        logw = torch.where(merge_ok, torch.logaddexp(logw, s_logw), logw)
        mo = merge_ok[:, None]
        psum = torch.where(mo, psum + s_psum, psum)
        adv_r, adv_l = mo & r2, mo & ~r2
        q_r, p_r, g_r = (torch.where(adv_r, qq, q_r),
                         torch.where(adv_r, pp, p_r),
                         torch.where(adv_r, gg, g_r))
        q_l, p_l, g_l = (torch.where(adv_l, qq, q_l),
                         torch.where(adv_l, pp, p_l),
                         torch.where(adv_l, gg, g_l))
        # Full-tree U-turn check after a successful merge.
        merged_turn = merge_ok & (
            (torch.sum(psum * (p_l * inv_mass), dim=-1) <= 0.0)
            | (torch.sum(psum * (p_r * inv_mass), dim=-1) <= 0.0))
        turning = torch.where(alive, torch.where(stop, s_turn, merged_turn),
                              turning)
        diverging = diverging | (alive & s_div)
        depth = depth + alive.to(torch.int32)
        alive = merge_ok & ~merged_turn

    accept_stat = sum_alpha / torch.clamp(n_leap.to(ldt), min=1.0)
    return (q_prop, lp_prop, h_prop, accept_stat, depth, n_leap, turning,
            diverging)


def latent_dict_ineligible(density, observed, q, mass, n_chain_dims,
                           max_tree_depth, wants):
    """Why the NUTS kernel cannot take a transition on the latent dict
    ``q`` under ``density``, a built-in over several latents (None if it
    can): the NUTS counterpart of
    :func:`~zhusuan_tpu_torch.mcmc.hmc.builtin_density_ineligible`, which
    HMC, ChEES and SGMCMC keep (one latent, as the JAX HMC gate). The
    latents must be the density's, each ``[n_chains]`` plus its shape, in
    float32 with a ``[1, ...]`` float32 mass; an observed leaf must be data
    the density holds."""
    if not isinstance(density, DENSITIES):
        return "the log-joint must be one of the built-in densities {}".format(
            ", ".join(c.__name__ for c in DENSITIES))
    if sorted(q) != list(density.names):
        return "the latents must be the built-in density's {}; got {}".format(
            list(density.names), sorted(q))
    for k, v in (observed or {}).items():
        if not density.holds(k, v):
            return ("the observed leaf {!r} is not data the built-in density "
                    "holds".format(k))
    if n_chain_dims != 1:
        return "the latents must have one chain axis"
    n_chains = None
    for k in density.names:
        x, shape = q[k], density.shapes[k]
        if (x.dtype != torch.float32 or x.ndim != 1 + len(shape)
                or tuple(x.shape[1:]) != shape
                or x.shape[0] != (n_chains or x.shape[0])):
            return ("latent {!r} must be [n_chains] + {} float32; got {} "
                    "{}".format(k, list(shape), tuple(x.shape), x.dtype))
        n_chains = x.shape[0]
        if mass is not None and (tuple(mass[k].shape) != (1,) + shape
                                 or mass[k].dtype != torch.float32):
            return "the mass of {!r} must be [1] + {} float32".format(
                k, list(shape))
    if not nuts_step_supported((n_chains, density.dim), max_tree_depth,
                               torch.float32):
        return "the flattened latents must be {}; got [{}, {}]".format(
            wants, n_chains, density.dim)
    return density.kernel_ineligible()


class NUTS:
    """No-U-Turn Sampler with multinomial trajectory sampling.

    The :class:`~zhusuan_tpu_torch.mcmc.hmc.HMC` surface (``init``,
    ``sample``, ``run``, the same state) with a trajectory that doubles
    until it turns back on itself or reaches ``max_tree_depth``, instead of
    a fixed ``n_leapfrogs``.

    :param step_size: initial leapfrog step size.
    :param max_tree_depth: maximum number of doublings per iteration
        (trajectories are at most ``2**max_tree_depth - 1`` new leaves).
    :param adapt_step_size: None disables dual averaging; a bool enables it
        and sets the default gate (override per call).
    :param target_acceptance_rate: dual-averaging target on the mean
        leaf-acceptance statistic.
    :param gamma, t0, kappa: dual-averaging hyperparameters (Hoffman &
        Gelman 2014; reference hmc.py:89-112).
    :param adapt_mass: None disables mass adaptation; a bool enables the EW
        moving-variance machinery (requires ``adapt_step_size``).
    :param mass_collect_iters: iterations before the adapted mass is used.
    :param mass_decay: EW variance decay.
    :param max_delta_energy: a leaf with ``H - H0 > max_delta_energy`` (or
        a NaN energy) ends the trajectory and is flagged divergent.
    :param experimental_fused_step: ``"auto"`` (default) runs the whole
        transition in the CUDA kernel whenever it is eligible (see the
        module docstring) and the plain path otherwise; ``False`` always
        takes the plain path; ``True`` requires the kernel for CUDA
        tensors and raises when they are not eligible. CPU tensors always
        take the plain path.
    """

    _VALID_FIELDS = (
        "samples", "acceptance_rate", "step_size", "log_prob", "depth",
        "n_leapfrogs", "divergent", "turning", "energy",
    )

    def __init__(
        self,
        step_size: float = 0.1,
        max_tree_depth: int = 10,
        adapt_step_size: Optional[bool] = None,
        target_acceptance_rate: float = 0.8,
        gamma: float = 0.05,
        t0: float = 100.0,
        kappa: float = 0.75,
        adapt_mass: Optional[bool] = None,
        mass_collect_iters: int = 10,
        mass_decay: float = 0.99,
        max_delta_energy: float = 1000.0,
        experimental_fused_step="auto",
    ):
        if not float(step_size) > 0.0:
            raise ValueError("step_size must be positive.")
        if int(max_tree_depth) < 1:
            raise ValueError("max_tree_depth must be >= 1.")
        if adapt_mass is not None and adapt_step_size is None:
            raise ValueError(
                "adapt_mass requires adapt_step_size (reference "
                "hmc.py:270-272).")
        self.init_step_size = float(step_size)
        self.max_tree_depth = int(max_tree_depth)
        self.adapt_step_size = adapt_step_size
        self.target_acceptance_rate = float(target_acceptance_rate)
        if not 0.0 < self.target_acceptance_rate < 1.0:
            raise ValueError("target_acceptance_rate must be in (0, 1).")
        self.gamma, self.t0, self.kappa = float(gamma), float(t0), float(kappa)
        self.adapt_mass = adapt_mass
        self.mass_collect_iters = (
            int(mass_collect_iters) if adapt_mass is not None else 0)
        self.mass_decay = float(mass_decay)
        self.max_delta_energy = float(max_delta_energy)
        if experimental_fused_step not in (True, False, "auto"):
            raise ValueError(
                "experimental_fused_step must be True, False, or 'auto'.")
        self.experimental_fused_step = experimental_fused_step
        self.mu = math.log(10.0 * self.init_step_size)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init(self, latent: Latent, n_chain_dims: Optional[int] = None,
             log_joint=None, observed=None) -> HMCState:
        """Create the initial :class:`HMCState` from initial positions of
        shape ``chain_axes + data_axes`` (see
        :meth:`~zhusuan_tpu_torch.mcmc.hmc.HMC.init`)."""
        return init_state(latent, self.init_step_size, n_chain_dims,
                          log_joint, observed)

    # ------------------------------------------------------------------ #
    def _fused_ineligible(self, meta_bn, observed, q, mass, n_chain_dims):
        """Why the kernel cannot take this transition (None if it can)."""
        depth = self.max_tree_depth
        wants = ("float32 with dim <= {} at 1 <= max_tree_depth <= {} (depth "
                 "{})".format(MAX_DIM, MAX_TREE_DEPTH, depth))
        if isinstance(meta_bn, LatentDictDensity):
            return latent_dict_ineligible(meta_bn, observed, q, mass,
                                          n_chain_dims, depth, wants)
        return builtin_density_ineligible(
            meta_bn, observed, q, mass, n_chain_dims,
            lambda shape, dtype: nuts_step_supported(shape, depth, dtype),
            DENSITIES, wants)

    def _use_fused_step(self, meta_bn, observed, q, mass, n_chain_dims):
        return use_kernel(self.experimental_fused_step, q,
                          lambda: self._fused_ineligible(
                              meta_bn, observed, q, mass, n_chain_dims))

    @staticmethod
    def _chain_shape(log_post, meta_bn, observed, q):
        """The chain shape (the log joint's output shape), checking that a
        model whose density is not scalar per chain carries the chain
        shape on some observed leaf (the JAX package's per-chain observed
        leaves)."""
        if (len(q) == 1 and isinstance(meta_bn, BuiltinDensity)
                and meta_bn.name in q):
            return tuple(q[meta_bn.name].shape[:-1])
        if (isinstance(meta_bn, LatentDictDensity)
                and sorted(q) == list(meta_bn.names)):
            first = q[meta_bn.names[0]]
            return tuple(first.shape[:first.ndim - len(
                meta_bn.shapes[meta_bn.names[0]])])
        chain_shape = tuple(log_post(q).shape)
        n = len(chain_shape)
        if n:
            probe = tuple(log_post(
                {k: v.new_zeros(v.shape[n:]) for k, v in q.items()}).shape)
            per_chain = [k for k, v in (observed or {}).items()
                         if tuple(torch.as_tensor(v).shape[:n])
                         == chain_shape]
            if probe != () and not per_chain:
                raise ValueError(
                    "The log joint evaluated on a chainless latent has "
                    "shape {} (expected a scalar), but no observed leaf "
                    "carries the chain shape {} -- the model appears to "
                    "mix chain and data axes in a way NUTS cannot split "
                    "per chain.".format(probe, chain_shape))
        return chain_shape

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def sample(self, meta_bn, observed, state: HMCState, key=None,
               adapt_step_size=None, adapt_mass=None, *, noise=None):
        """Run ONE NUTS iteration over all chains: ``(state, key) ->
        (state, NUTSInfo)``.

        :param meta_bn: ``meta_bn(obs_dict)`` callable, e.g. a
            built-in density of :mod:`~zhusuan_tpu_torch.ops.densities`,
            or a :class:`~zhusuan_tpu_torch.framework.MetaBayesianNet`.
        :param observed: dict of observations; a leaf may carry the chain
            shape (per-chain conditioning).
        :param state: current :class:`HMCState`.
        :param key: key ``(k0, k1)`` or a ``torch.Generator`` to draw one
            from; the draws of iteration ``t`` depend only on the key and
            ``t`` (the kernel's Philox counter word, or the seed of the
            plain path's generator).
        :param adapt_step_size: optional bool gating step-size adaptation
            this iteration (default: the constructor setting).
        :param adapt_mass: optional bool gating mass adaptation.
        :param noise: testing hook: ``(eps, u_dir, u_leaf, u_merge)`` in
            :func:`nuts_transition`'s layout over the flattened chains
            (``eps`` ravels the latents in sorted-name order), replacing
            the draws.
        :return: ``(new_state, NUTSInfo)``.
        """
        log_post = make_log_joint_fn(meta_bn, observed)
        state_dtypes = {k: v.dtype for k, v in state.q.items()}
        # bf16 state: compute in f32, round back at the state write.
        q = {k: (v.float() if v.dtype == torch.bfloat16 else v)
             for k, v in state.q.items()}
        chain_shape = self._chain_shape(log_post, meta_bn, observed, q)
        n_chain_dims = len(chain_shape)
        n_chains = math.prod(chain_shape)
        flat = _Flattener(q, n_chain_dims)
        new_t = state.t + 1

        # --- mass adaptation (shared EWMV; reference hmc.py:283-305) --- #
        if self.adapt_mass is not None:
            gate_mass = adapt_mass if adapt_mass is not None \
                else self.adapt_mass
            with adapt_span("zs.adapt.mass", gate_mass):
                ewmv_t, ewmv_mean, ewmv_var, mass = mass_update(
                    state, gate_mass, n_chain_dims, self.mass_decay,
                    self.mass_collect_iters)
        else:
            ewmv_t, ewmv_mean, ewmv_var = (
                state.ewmv_t, state.ewmv_mean, state.ewmv_var)
            mass = state.mass

        # inv_mass as a flat [dim] vector (mass leaves are
        # (1,)*n_chain_dims + data_shape, shared across chains).
        inv_mass = 1.0 / flat.ravel(
            {k: mass[k].reshape(mass[k].shape[n_chain_dims:]) for k in q},
            ())
        eps = state.step_size.to(flat.dtype)
        D = self.max_tree_depth

        with span("zs.transition"):
            if self._use_fused_step(meta_bn, observed, state.q, mass,
                                    n_chain_dims):
                outs = fused_nuts_transition(
                    meta_bn, flat.ravel(state.q, (n_chains,)),
                    inv_mass[None, :], eps, D, self.max_delta_energy,
                    as_key(key), new_t, noise=noise)
            else:
                q_flat = flat.ravel(q, (n_chains,))

                def log_prob(x):
                    latent = flat.unravel(
                        x.reshape(chain_shape + (flat.dim,)), chain_shape)
                    return log_post(latent).reshape(n_chains)

                if noise is None:
                    gen = iteration_generator(as_key(key), new_t,
                                              q_flat.device)
                    noise = draw_noise(gen, n_chains, flat.dim, D,
                                       flat.dtype, q_flat.device)
                outs = nuts_transition(value_and_grad(log_prob), q_flat,
                                       inv_mass, eps, D,
                                       self.max_delta_energy, noise)
        (q_new_flat, lp_new, h_new, accept_stat, depth, n_leap, turning,
         divergent) = [v.reshape(chain_shape + v.shape[1:]) for v in outs]
        q_new = flat.unravel(q_new_flat, chain_shape)

        # --- step-size adaptation (shared dual averaging) -------------- #
        if self.adapt_step_size is not None:
            gate = adapt_step_size if adapt_step_size is not None \
                else self.adapt_step_size
            with adapt_span("zs.adapt.step_size", gate):
                step_size, da_step, h_bar, log_eps_bar = (
                    dual_averaging_update(
                        state.da_step, state.h_bar, state.log_epsilon_bar,
                        state.step_size, torch.mean(accept_stat), gate,
                        fresh_start=state.t == 0,
                        mu=self.mu, target=self.target_acceptance_rate,
                        gamma=self.gamma, t0=self.t0, kappa=self.kappa))
                ss_dtype = state.step_size.dtype
                step_size = step_size.to(ss_dtype)
                da_step = da_step.to(state.da_step.dtype)
                h_bar = h_bar.to(ss_dtype)
                log_eps_bar = log_eps_bar.to(ss_dtype)
        else:
            step_size, da_step, h_bar, log_eps_bar = (
                state.step_size, state.da_step, state.h_bar,
                state.log_epsilon_bar)

        new_state = HMCState(
            q={k: v.to(state_dtypes[k]) for k, v in q_new.items()},
            t=new_t,
            step_size=step_size,
            da_step=da_step,
            h_bar=h_bar,
            log_epsilon_bar=log_eps_bar,
            ewmv_t=ewmv_t,
            ewmv_mean=ewmv_mean,
            ewmv_var=ewmv_var,
            mass=mass,
        )
        info = NUTSInfo(
            samples=q_new,
            acceptance_rate=accept_stat,
            updated_step_size=step_size,
            log_prob=lp_new,
            depth=depth,
            n_leapfrogs=n_leap,
            divergent=divergent,
            turning=turning,
            energy=h_new,
        )
        return new_state, info

    # ------------------------------------------------------------------ #
    def run(self, meta_bn, observed, state: HMCState, key, n_iters: int,
            n_adapt: int = 0, collect: bool = True,
            collect_fields=("samples", "acceptance_rate", "step_size",
                            "log_prob", "depth", "divergent"),
            thinning: int = 1):
        """Run ``n_iters`` iterations in a Python loop over :meth:`sample`.

        Adaptation is gated on the host-int counter ``state.t < n_adapt``.
        The key is drawn once, here, from ``key`` (a ``torch.Generator`` or
        a ``(k0, k1)`` pair); each iteration's draws follow from it and
        ``state.t``.

        :param collect: stack per-iteration outputs when True; otherwise
            only the final state is returned.
        :param collect_fields: which outputs to stack (subset of
            ``samples``, ``acceptance_rate``, ``step_size``, ``log_prob``,
            ``depth``, ``n_leapfrogs``, ``divergent``, ``turning``,
            ``energy``).
        :param thinning: stack every ``thinning``-th iteration only: the
            output is the full trajectory sliced ``thinning-1::thinning``
            (``n_iters // thinning`` rows), written into preallocated
            buffers.
        :return: ``(final_state, {field: stacked} or None)``.
        """
        for f in collect_fields:
            if f not in self._VALID_FIELDS:
                raise ValueError("Unknown collect field {!r}; valid: {}."
                                 .format(f, self._VALID_FIELDS))
        key = as_key(key)
        adapt_on = self.adapt_step_size is not None and n_adapt > 0

        def one(st, i):
            gate = st.t < n_adapt if adapt_on else False
            return self.sample(meta_bn, observed, st, key,
                               adapt_step_size=gate, adapt_mass=gate)

        def pick(info):
            full = {
                "samples": info.samples,
                "acceptance_rate": info.acceptance_rate,
                "step_size": info.updated_step_size,
                "log_prob": info.log_prob,
                "depth": info.depth,
                "n_leapfrogs": info.n_leapfrogs,
                "divergent": info.divergent,
                "turning": info.turning,
                "energy": info.energy,
            }
            return {f: full[f] for f in collect_fields}

        return run_driver(one, pick, state, n_iters, collect, thinning)
