"""Block-wise Gibbs composition of MCMC kernels (port of
``zhusuan_tpu/mcmc/gibbs.py``).

:class:`Gibbs` cycles sub-kernels over disjoint latent blocks: HMC on the
smooth block, a :class:`~zhusuan_tpu_torch.mcmc.SliceSampler` on
non-differentiable hyperparameters, :class:`~zhusuan_tpu_torch.mcmc.
DiscreteGibbs` on discrete labels, ... Each block's conditional is the
model's joint with the other blocks' current values OBSERVED (the
``make_log_joint_fn`` merge), so any model usable with one kernel is usable
block-wise with no extra code.

A sweep is a Python loop over the components; sub-kernel tuning state
(dual-averaged step sizes, mass and width accumulators) persists inside
:class:`GibbsState`. A cached-density sub-state (RWM, MALA, slice) is
re-evaluated on each visit, since the other blocks moved; the port
re-evaluates it without reading the NaN sentinel back.

``key`` (a ``torch.Generator`` or a Philox key pair) gives component ``i``
the key ``(k0, k1 + (i + 1) * 0x9E3779B9 mod 2^32)``; each component then
draws from its own iteration counter as it does alone.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from zhusuan_tpu_torch.mcmc.base import run_driver
from zhusuan_tpu_torch.mcmc.discrete import DiscreteGibbs
from zhusuan_tpu_torch.mcmc.hmc import HMC
from zhusuan_tpu_torch.mcmc.nuts import NUTS
from zhusuan_tpu_torch.mcmc.rwm import FILL, _MetropolisBase
from zhusuan_tpu_torch.mcmc.slice_sampler import SliceSampler
from zhusuan_tpu_torch.ops._random import as_key
from zhusuan_tpu_torch.utils import merge_dicts

__all__ = ["Gibbs", "GibbsState", "GibbsInfo"]

Latent = Dict[str, torch.Tensor]


class GibbsState(NamedTuple):
    """Explicit compound-kernel state: one sub-state per component (each
    carrying its block's positions in ``.q``) plus the sweep counter, a
    host int."""

    sub_states: Tuple
    t: int

    @property
    def q(self) -> Latent:
        """The full latent dict, merged across blocks."""
        out = {}
        for sub in self.sub_states:
            out.update(sub.q)
        return out


class GibbsInfo(NamedTuple):
    """Per-sweep statistics."""

    samples: Latent  # merged across blocks
    log_prob: torch.Tensor  # [chain_shape] FULL log joint after the sweep


def _component_step(kernel):
    """``(meta_bn, observed, sub_state, key, gate, noise) -> (sub_state,
    info)`` for one supported sub-kernel family."""
    if isinstance(kernel, (HMC, NUTS)):
        # HMCState holds only position + tuning accumulators: re-targeting
        # needs no invalidation.
        def step(meta_bn, observed, sub, key, gate, noise):
            kw = {}
            if kernel.adapt_step_size is not None:
                kw["adapt_step_size"] = gate
            if kernel.adapt_mass is not None:
                kw["adapt_mass"] = gate
            return kernel.sample(meta_bn, observed, sub, key, noise=noise,
                                 **kw)

        return step
    if isinstance(kernel, (_MetropolisBase, SliceSampler)):
        # Honour the sub-kernel's own adaptation switch; the cached density
        # was computed under the other blocks' PREVIOUS values: refill it.
        adapts = kernel._adapt

        def step(meta_bn, observed, sub, key, gate, noise):
            return kernel._transition(meta_bn, observed, sub, key,
                                      gate if adapts else False, noise, FILL)

        return step
    if isinstance(kernel, DiscreteGibbs):
        def step(meta_bn, observed, sub, key, gate, noise):
            return kernel.sample(meta_bn, observed, sub, key, noise=noise)

        return step
    raise TypeError(
        "Unsupported Gibbs component kernel {!r}. Supported: HMC, NUTS, "
        "RandomWalkMetropolis, MALA, SliceSampler, DiscreteGibbs. "
        "(EllipticalSlice is excluded on purpose: it consumes the "
        "LIKELIHOOD factor only, not the model's full log-joint, so "
        "composing it requires the prior-free conditional; run it "
        "standalone.)".format(type(kernel)))


def component_key(key, i: int):
    """Component ``i``'s key from the sweep's key pair."""
    return key[0], (key[1] + (i + 1) * 0x9E3779B9) & 0xFFFFFFFF


class Gibbs:
    """Cycle sub-kernels over disjoint latent blocks, in order, once per
    sweep.

    :param components: sequence of ``(kernel, names)`` pairs: a kernel
        instance and the list of latent names it owns. Blocks must be
        disjoint and, together with ``observed`` at sample time, cover the
        model's free variables.
    """

    def __init__(self, components: Sequence[Tuple[object, Sequence[str]]]):
        components = [(k, list(names)) for k, names in components]
        if not components:
            raise ValueError("Gibbs needs at least one component.")
        seen = set()
        for kernel, names in components:
            if not names:
                raise ValueError("Each component needs >= 1 latent name.")
            dup = seen.intersection(names)
            if dup:
                raise ValueError(
                    "Latent blocks must be disjoint; {} appear in more than "
                    "one component.".format(sorted(dup)))
            seen.update(names)
        self._components = components
        self._steps = [_component_step(k) for k, _ in components]

    # ------------------------------------------------------------------ #
    def init(self, latent: Latent, n_chain_dims: int) -> GibbsState:
        """The initial state at positions of shape ``chain_axes +
        data_axes``; the latent dict is split across components by name."""
        latent = {k: torch.as_tensor(v) for k, v in latent.items()}
        owned = {n for _, names in self._components for n in names}
        missing = owned - set(latent)
        extra = set(latent) - owned
        if missing or extra:
            raise ValueError(
                "Component blocks must exactly cover the latent dict; "
                "missing {}, unowned {}.".format(sorted(missing),
                                                 sorted(extra)))
        subs = [kernel.init({n: latent[n] for n in names},
                            n_chain_dims=n_chain_dims)
                for kernel, names in self._components]
        return GibbsState(sub_states=tuple(subs), t=0)

    # ------------------------------------------------------------------ #
    def sample(self, meta_bn, observed, state: GibbsState, key=None,
               adapt=None, *, noise=None):
        """One full sweep (every component once, in order).

        :param key: a ``torch.Generator`` or a Philox key ``(k0, k1)``.
        :param adapt: bool gating EVERY component's adaptation (sub-kernels
            constructed without adaptation ignore it).
        :param noise: testing hook in place of ``key``: a sequence with one
            ``noise`` per component, in its own ``sample``'s layout.
        :return: ``(new_state, GibbsInfo)``.
        """
        gate = False if adapt is None else adapt
        key = None if noise is not None else as_key(key)
        subs = list(state.sub_states)
        info_lp = None
        for i, step in enumerate(self._steps):
            others = {}
            for j, sub in enumerate(subs):
                if j != i:
                    others.update(sub.q)
            cond_obs = merge_dicts(observed, others)
            subs[i], info = step(
                meta_bn, cond_obs, subs[i],
                None if key is None else component_key(key, i), gate,
                None if noise is None else noise[i])
            # Each component's log_prob is the FULL joint at the current
            # position; the LAST component's is the sweep's.
            info_lp = info.log_prob
        new_state = GibbsState(sub_states=tuple(subs), t=state.t + 1)
        return new_state, GibbsInfo(samples=new_state.q, log_prob=info_lp)

    # ------------------------------------------------------------------ #
    _VALID_FIELDS = ("samples", "log_prob")

    def run(
        self,
        meta_bn,
        observed,
        state: GibbsState,
        key,
        n_iters: int,
        n_adapt: int = 0,
        collect: bool = True,
        collect_fields=("samples", "log_prob"),
        thinning: int = 1,
        *,
        noise=None,
    ):
        """``n_iters`` sweeps in a Python loop over :meth:`sample`.
        Adaptation (all components) is gated on the PERSISTED counter
        ``state.t < n_adapt`` (the ``HMC.run`` convention).

        :param noise: testing hook: a sequence of ``n_iters`` of
            :meth:`sample`'s ``noise``.
        :return: ``(final_state, {field: stacked} or None)``.
        """
        for f in collect_fields:
            if f not in self._VALID_FIELDS:
                raise ValueError("Unknown collect field {!r}; valid: {}."
                                 .format(f, self._VALID_FIELDS))
        key = None if noise is not None else as_key(key)

        def one(st, i):
            return self.sample(meta_bn, observed, st, key,
                               adapt=n_adapt > 0 and st.t < n_adapt,
                               noise=None if noise is None else noise[i])

        def pick(info):
            full = {"samples": info.samples, "log_prob": info.log_prob}
            return {f: full[f] for f in collect_fields}

        return run_driver(one, pick, state, n_iters, collect, thinning)
