"""Sampler validation: Geweke (2004) joint tests and simulation-based
calibration (Talts et al. 2018) (port of ``zhusuan_tpu/testing.py``).

Geweke's joint-distribution test holds a TRANSITION KERNEL against a MODEL
exactly. Two simulators target the same joint ``p(latent, data)``:

- *marginal-conditional*: ``latent ~ p(latent)``, then ``data ~ p(data |
  latent)``: exact independent joint draws;
- *successive-conditional*: a Markov chain alternating ``data ~ p(data |
  latent)`` (exact, from the model) with ``latent <- K(latent | data)``
  (the kernel under test, which must leave ``p(latent | data)``
  invariant).

If the kernel is right, every statistic ``g(latent, data)`` agrees in
expectation between the two; a z-score past ~4-5 exposes a fault. The
chains start in stationarity (the initial point is itself a joint draw), and
per-chain means over independent vectorized chains give the standard error
without autocorrelation machinery.

Typical use::

    res = geweke_test(model_meta_bn, zt.HMC(step_size=0.3, n_leapfrogs=5),
                      latent=["mu"], data=["y"], key=generator)
    assert res.max_abs_z < 5.0, res.z_scores

The model's nodes must broadcast over a leading chain axis fed through the
latent, and the latent/data split must cover every stochastic node.

The JAX package draws the joint samples with one ``vmap`` over keys and
runs the successive-conditional chain as one ``lax.scan``. Here the joint
draws are one batch under ``torch.func.vmap(..., randomness="different")``
(each net's nodes draw a batch of numbers from their generators), and the
chain is a Python loop of ``n_iters`` steps whose statistics stay on the
device until one read at the end.

Keys: ``key`` is a CPU ``torch.Generator``, a Philox key pair ``(k0, k1)``
or None (the default generator's draw); the sub-keys of the phases and of
each iteration are derived on the host
(:func:`~zhusuan_tpu_torch.ops._random.child_key`, the counterpart of
``split``), a net's int seed from its key pair.

Reference: Geweke (2004), "Getting it right: joint distribution tests of
posterior simulators", JASA 99(467).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from zhusuan_tpu_torch.framework.bn import StochasticTensor
from zhusuan_tpu_torch.mcmc.discrete import DiscreteGibbs
from zhusuan_tpu_torch.mcmc.hmc import HMC
from zhusuan_tpu_torch.mcmc.nuts import NUTS
from zhusuan_tpu_torch.mcmc.rwm import _MetropolisBase
from zhusuan_tpu_torch.mcmc.slice_sampler import SliceSampler
from zhusuan_tpu_torch.ops._random import as_key, child_key

__all__ = ["geweke_test", "GewekeResult", "sbc_test", "SBCResult"]


class GewekeResult(NamedTuple):
    """Output of :func:`geweke_test`."""

    z_scores: Dict[str, float]  # per-statistic z between the simulators
    max_abs_z: float  # the headline: > ~5 means a broken kernel
    mc_means: Dict[str, float]  # marginal-conditional statistic means
    sc_means: Dict[str, float]  # successive-conditional statistic means
    n_mc: int  # independent joint draws used
    n_chains: int  # successive-conditional chains
    n_iters: int  # successive-conditional iterations per chain


def _seed(key) -> int:
    """A net's int seed from a key pair."""
    return (int(key[0]) << 32) | int(key[1])


def _flat_mean(x):
    x = torch.as_tensor(x)
    return torch.mean(x, dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


def _default_statistics(latent: List[str], data: List[str]):
    """First and second moments of each latent plus latent-data cross
    moments: the Geweke-recommended minimum battery."""
    stats = {}
    for name in latent:
        stats["mean[{}]".format(name)] = (
            lambda v, n=name: _flat_mean(v[n]))
        stats["m2[{}]".format(name)] = (
            lambda v, n=name: _flat_mean(torch.square(torch.as_tensor(
                v[n]))))
        for dname in data:
            stats["cross[{},{}]".format(name, dname)] = (
                lambda v, n=name, d=dname:
                _flat_mean(v[n]) * _flat_mean(v[d]))
    return stats


def _check_split(meta_bn, latent, data):
    """Return the probe net's device after checking, once and eagerly,
    that ``latent + data`` names the model's stochastic nodes exactly (a
    forgotten node would be redrawn on BOTH sides and mask kernel
    faults)."""
    probe = meta_bn.observe(key=0)
    stochastic = [n for n, node in probe.nodes.items()
                  if isinstance(node, StochasticTensor)]
    names = latent + data
    missing = sorted(set(stochastic) - set(names))
    extra = sorted(set(names) - set(stochastic))
    if missing or extra:
        raise ValueError(
            "latent + data must cover the model's stochastic nodes "
            "exactly; missing {}, unknown {}.".format(missing, extra))
    return probe[stochastic[0]].tensor.device if stochastic else None


def _joint_draws(meta_bn, names, key, n, device):
    """``n`` independent joint draws ``{name: [n, ...]}``: one batch of
    the model under ``vmap`` with different randomness per draw."""

    def one(_):
        bn = meta_bn.observe(key=_seed(key))
        return {k: bn[k].tensor for k in names}

    with torch.no_grad():
        return torch.func.vmap(one, randomness="different")(
            torch.zeros(int(n), device=device))


def _make_transition(kernel):
    """Adapt a sampler to ``init(latent) -> carry`` and ``step(meta_bn,
    observed, latent, carry, key, noise) -> (latent, carry)`` with EVERY
    adaptation channel frozen: Geweke requires a fixed
    ``p(latent | data)``-invariant kernel."""
    if isinstance(kernel, HMC):
        adapt_ss = False if kernel.adapt_step_size is not None else None
        adapt_m = False if kernel.adapt_mass is not None else None

        def init(latent):
            return kernel.init(latent, n_chain_dims=1)

        def step(meta_bn, observed, latent, carry, key, noise):
            # HMC evaluates the density afresh each iteration (no carried
            # cache), so the fresh data draw needs no invalidation.
            carry, _ = kernel.sample(
                meta_bn, observed, carry._replace(q=latent), key,
                adapt_step_size=adapt_ss, adapt_mass=adapt_m,
                init_step_size_search=False, noise=noise)
            return carry.q, carry

        return init, step
    if isinstance(kernel, NUTS):
        def init(latent):
            return kernel.init(latent, n_chain_dims=1)

        def step(meta_bn, observed, latent, carry, key, noise):
            carry, _ = kernel.sample(
                meta_bn, observed, carry._replace(q=latent), key,
                adapt_step_size=False, adapt_mass=False, noise=noise)
            return carry.q, carry

        return init, step
    if isinstance(kernel, (_MetropolisBase, SliceSampler, DiscreteGibbs)):
        def init(latent):
            return kernel.init(latent, n_chain_dims=1)

        def step(meta_bn, observed, latent, carry, key, noise):
            # The carried density cache was computed under the PREVIOUS
            # data draw: the NaN sentinel forces a re-evaluation against
            # the fresh conditional.
            carry = carry._replace(q=latent).invalidate_cache()
            carry, _ = kernel.sample(meta_bn, observed, carry, key,
                                     adapt=False, noise=noise)
            return carry.q, carry

        return init, step
    if callable(kernel):
        # Raw transition: latent' = kernel(meta_bn, observed, latent, key)
        # (stateless; how a broken kernel is injected).
        def init(latent):
            return None

        def step(meta_bn, observed, latent, carry, key, noise):
            return kernel(meta_bn, observed, latent, key), None

        return init, step
    raise TypeError(
        "kernel must be an HMC or NUTS instance, a Metropolis-family "
        "sampler (RandomWalkMetropolis/MALA), a SliceSampler, a "
        "DiscreteGibbs, or a callable transition ``(meta_bn, observed, "
        "latent_dict, key) -> latent_dict``; got {!r}.".format(type(kernel)))


def _as_host64(x):
    return torch.as_tensor(x).detach().to("cpu", torch.float64).numpy()


def geweke_test(
    meta_bn,
    kernel,
    latent: List[str],
    data: List[str],
    key=None,
    n_iters: int = 2000,
    n_chains: int = 64,
    n_mc: int = 100_000,
    statistics: Optional[Dict[str, Callable]] = None,
    *,
    noise=None,
) -> GewekeResult:
    """Run the Geweke joint-distribution test of ``kernel`` against
    ``meta_bn`` on the model's device: the marginal-conditional side is
    one batched prior sweep, the successive-conditional side a loop of
    ``n_iters`` steps over ``n_chains`` vectorized chains with one host
    read at the end.

    :param meta_bn: the model (a MetaBayesianNet); ``latent`` + ``data``
        must name all of its stochastic nodes.
    :param kernel: sampler under test (HMC, NUTS, RWM, MALA, SliceSampler
        or DiscreteGibbs: adaptation is frozen), or a raw transition
        callable ``(meta_bn, observed, latent_dict, key) -> latent_dict``,
        ``key`` a Philox key pair an iteration.
    :param latent: latent node names (the kernel's targets).
    :param data: data node names (redrawn from the model each step).
    :param key: a CPU ``torch.Generator``, a key pair or None.
    :param n_iters: successive-conditional steps per chain.
    :param n_chains: vectorized successive-conditional chains (standard
        errors come from the spread of per-chain means).
    :param n_mc: independent marginal-conditional joint draws.
    :param statistics: optional ``{name: fn(values_dict) -> [C]}``
        overriding the default moment battery; each fn maps the node-value
        dict (chain axis leading) to a per-chain scalar.
    :param noise: testing hook replacing every draw but the kernel's:
        ``{"mc": {name: [n_mc, ...]}, "init": {name: [n_chains, ...]},
        "data": {name: [n_iters, n_chains, ...]}}``, the joint draws of
        both sides and each step's base draws of the data nodes (fed
        through ``MetaBayesianNet.observe_with_noise``); an optional
        ``"kernel"`` sequence gives the sampler's ``noise=`` an iteration.
    :return: :class:`GewekeResult`.
    """
    latent = list(latent)
    data = list(data)
    names = latent + data
    device = _check_split(meta_bn, latent, data)
    stats = statistics or _default_statistics(latent, data)
    init_fn, step_fn = _make_transition(kernel)

    key = as_key(key)
    key_mc, key_init, key_scan = (child_key(key, i) for i in range(3))

    # --- marginal-conditional: independent joint draws ----------------- #
    if noise is not None:
        mc_vals = {k: torch.as_tensor(v) for k, v in noise["mc"].items()}
        init_vals = {k: torch.as_tensor(v)
                     for k, v in noise["init"].items()}
    else:
        mc_vals = _joint_draws(meta_bn, names, key_mc, n_mc, device)
        init_vals = _joint_draws(meta_bn, names, key_init, n_chains, device)
    with torch.no_grad():
        mc_stats = {name: _as_host64(fn(mc_vals))
                    for name, fn in stats.items()}
    del mc_vals

    # --- successive-conditional chain ---------------------------------- #
    lat = {n: init_vals[n] for n in latent}
    carry = init_fn(lat)
    series = {name: [] for name in stats}
    kernel_noise = None if noise is None else noise.get("kernel")
    with torch.no_grad():
        for i in range(int(n_iters)):
            k = child_key(key_scan, i)
            if noise is not None:
                bn = meta_bn.observe_with_noise(
                    {n: noise["data"][n][i] for n in data}, **lat)
            else:
                bn = meta_bn.observe(key=_seed(child_key(k, 0)), **lat)
            obs = {n: bn[n].tensor for n in data}
            lat, carry = step_fn(
                meta_bn, obs, lat, carry, child_key(k, 1),
                None if kernel_noise is None else kernel_noise[i])
            vals = dict(lat)
            vals.update(obs)
            for name, fn in stats.items():
                series[name].append(fn(vals))

    z_scores, mc_means, sc_means = {}, {}, {}
    for name in stats:
        mc = mc_stats[name]
        mc_mean = float(np.mean(mc))
        mc_se = float(np.std(mc, ddof=1) / np.sqrt(mc.shape[0]))
        # [n_iters, n_chains], read once.
        chain_means = _as_host64(torch.stack(series[name])).mean(axis=0)
        sc_mean = float(np.mean(chain_means))
        sc_se = float(
            np.std(chain_means, ddof=1) / np.sqrt(chain_means.shape[0]))
        z = (mc_mean - sc_mean) / float(np.hypot(mc_se, sc_se))
        z_scores[name] = float(z)
        mc_means[name] = mc_mean
        sc_means[name] = sc_mean

    return GewekeResult(
        z_scores=z_scores,
        max_abs_z=float(np.max(np.abs(list(z_scores.values())))),
        mc_means=mc_means,
        sc_means=sc_means,
        n_mc=int(n_mc),
        n_chains=int(n_chains),
        n_iters=int(n_iters),
    )


class SBCResult(NamedTuple):
    """Output of :func:`sbc_test`."""

    ranks: Dict[str, np.ndarray]  # per-statistic ranks in {0..n_draws}
    histograms: Dict[str, np.ndarray]  # binned rank counts [n_bins]
    p_values: Dict[str, float]  # chi-square uniformity p per statistic
    min_p_value: float  # the headline: tiny => miscalibrated inference
    n_sims: int
    n_draws: int  # posterior draws ranked against (L)
    expected_per_bin: float


def sbc_test(
    meta_bn,
    kernel,
    latent: List[str],
    data: List[str],
    key=None,
    n_sims: int = 256,
    n_draws: int = 63,
    thinning: int = 10,
    n_warmup: int = 300,
    n_bins: int = 16,
    statistics: Optional[Dict[str, Callable]] = None,
    *,
    noise=None,
) -> SBCResult:
    """Simulation-based calibration (Talts et al. 2018): rank-uniformity
    validation of a full inference procedure.

    For each of ``n_sims`` simulations a joint draw ``(theta_s, y_s) ~
    p(theta, data)`` gives a dataset and an EXACT posterior sample
    ``theta_s`` of ``p(theta | y_s)``. The sampler then makes ``n_draws``
    more posterior draws for the same ``y_s``; if it is calibrated, the rank
    of ``g(theta_s)`` among ``{g(theta'_l)}`` is uniform on ``{0..n_draws}``
    for any scalar statistic ``g``. A U-shaped histogram means the
    posterior is too narrow, a hump too wide, a slope a bias.

    All ``n_sims`` simulations run as ONE vectorized chain axis (per-sim
    data rides the same leading axis through ``observed``): two
    ``kernel.run`` calls, adaptation then thinned collection. The chains
    start at the exact draws ``theta_s``, so no burn-in is discarded;
    ``n_warmup`` only adapts the step size.

    :param meta_bn: the model; ``latent`` + ``data`` must cover its
        stochastic nodes (checked).
    :param kernel: any sampler with the library's ``init``/``run`` contract
        (HMC, NUTS, RandomWalkMetropolis, MALA, ...).
    :param key: a CPU ``torch.Generator``, a key pair or None.
    :param statistics: optional ``{name: fn(latent_dict) -> [S]}`` per-sim
        scalar statistics; default: flat mean and second moment of every
        latent.
    :param noise: testing hook: ``{"joint": {name: [n_sims, ...]}}``, the
        joint draws in place of the model's.
    :return: :class:`SBCResult`; check ``min_p_value`` (with a
        multiple-comparison margin) or plot ``histograms``.
    """
    from scipy import stats as _sps

    latent = list(latent)
    data = list(data)
    names = latent + data
    device = _check_split(meta_bn, latent, data)
    if (n_draws + 1) % n_bins != 0:
        raise ValueError(
            "n_draws + 1 ({}) must be divisible by n_bins ({}) so rank "
            "bins have equal prior mass (Talts et al. recommend e.g. "
            "n_draws=63, n_bins=16).".format(n_draws + 1, n_bins))

    if statistics is None:
        statistics = _default_statistics(latent, [])

    key = as_key(key)
    key_joint, key_warm, key_run = (child_key(key, i) for i in range(3))

    if noise is not None:
        vals = {k: torch.as_tensor(v) for k, v in noise["joint"].items()}
    else:
        vals = _joint_draws(meta_bn, names, key_joint, n_sims, device)
    theta0 = {n: vals[n] for n in latent}
    observed = {n: vals[n] for n in data}

    state = kernel.init(theta0, n_chain_dims=1)
    if n_warmup > 0:
        state, _ = kernel.run(meta_bn, observed, state, key_warm,
                              n_iters=n_warmup, n_adapt=n_warmup,
                              collect=False)
    state, out = kernel.run(meta_bn, observed, state, key_run,
                            n_iters=n_draws * thinning, n_adapt=0,
                            collect_fields=("samples",), thinning=thinning)
    draws = out["samples"]  # {name: [n_draws, n_sims, ...]}

    ranks, hists, pvals = {}, {}, {}
    edges = np.arange(0, n_draws + 2, (n_draws + 1) // n_bins)
    with torch.no_grad():
        for sname, fn in statistics.items():
            g0 = _as_host64(fn(theta0))  # [S]
            gd = _as_host64(torch.func.vmap(fn)(draws))  # [n_draws, S]
            r = np.sum(gd < g0[None, :], axis=0).astype(np.int64)  # [S]
            hist = np.histogram(r, bins=edges)[0]
            expected = n_sims / n_bins
            chi2 = float(np.sum((hist - expected) ** 2 / expected))
            pvals[sname] = float(_sps.chi2.sf(chi2, df=n_bins - 1))
            ranks[sname] = r
            hists[sname] = hist

    return SBCResult(
        ranks=ranks,
        histograms=hists,
        p_values=pvals,
        min_p_value=float(np.min(list(pvals.values()))),
        n_sims=int(n_sims),
        n_draws=int(n_draws),
        expected_per_bin=float(n_sims / n_bins),
    )
