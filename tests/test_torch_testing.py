"""Parity and verdict tests of the port's sampler validation
(``zhusuan_tpu_torch/testing.py``) against ``zhusuan_tpu/testing.py``.

Arithmetic: both packages are fed the same joint draws (JAX's own, rebuilt
from its key: ``split(key, 3)`` into the marginal-conditional, initial and
scan keys, a step's data normals from ``fold_in(split(split(k_scan,
n_iters)[i])[0], crc32("y"))``) through the port's ``noise=`` hook, with a
deterministic stub kernel, so both results are functions of the same
numbers; the statistic batteries, z-scores, ranks, histograms and p-values
then agree at 1e-12 in float64.

Verdicts: every Geweke and SBC verdict of ``tests/test_geweke.py``,
``tests/test_sbc.py`` and ``tests/test_discrete_gibbs.py``'s Geweke test
holds in the port at the JAX tests' sizes, on the port's own random
streams.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu.testing import geweke_test as jax_geweke_test
from zhusuan_tpu.testing import sbc_test as jax_sbc_test
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc.base import make_grad_fn, make_log_joint_fn
from zhusuan_tpu_torch.ops._random import iteration_generator
from zhusuan_tpu_torch.testing import (
    GewekeResult,
    SBCResult,
    geweke_test,
    sbc_test,
)

F64 = torch.float64
SIGMA = 0.7
N_OBS = 5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@meta_bayesian_net()
def conjugate_model():
    """``tests/test_geweke.py``'s model: mu ~ N(0, 1), three y ~ N(mu,
    0.7)."""
    bn = BayesianNet()
    mu = bn.normal("mu", torch.tensor(0.0, dtype=F64), std=1.0)
    bn.normal("y", mu.tensor[..., None] * torch.ones(3, dtype=F64),
              std=SIGMA, group_ndims=1)
    return bn


@meta_bayesian_net()
def sbc_model():
    """``tests/test_sbc.py``'s model: mu ~ N(0, 1), five y ~ N(mu, 1)."""
    bn = BayesianNet()
    mu = bn.normal("mu", torch.tensor(0.0, dtype=F64),
                   std=torch.tensor(1.0, dtype=F64))
    mean = mu.tensor[..., None].expand(mu.tensor.shape + (N_OBS,))
    bn.normal("y", mean, std=torch.tensor(1.0, dtype=F64), group_ndims=1)
    return bn


@zs.meta_bayesian_net()
def jax_conjugate_model():
    bn = zs.BayesianNet()
    mu = bn.normal("mu", jnp.float64(0.0), std=jnp.float64(1.0))
    bn.normal("y", mu.tensor[..., None] * jnp.ones(3, jnp.float64),
              std=jnp.float64(SIGMA), group_ndims=1)
    return bn


@zs.meta_bayesian_net()
def jax_sbc_model():
    bn = zs.BayesianNet()
    mu = bn.normal("mu", jnp.float64(0.0), std=jnp.float64(1.0))
    mean = jnp.broadcast_to(mu.tensor[..., None],
                            mu.tensor.shape + (N_OBS,))
    bn.normal("y", mean, std=jnp.float64(1.0), group_ndims=1)
    return bn


def _jax_joint_draws(meta_bn, names, key, n):
    def one(k):
        bn = meta_bn.observe(key=k)
        return {m: bn._node_value(bn.nodes[m]) for m in names}

    vals = jax.vmap(one)(jax.random.split(key, n))
    return {m: torch.as_tensor(np.array(v)) for m, v in vals.items()}


# --------------------------------------------------------------------- #
# Arithmetic parity on injected draws
# --------------------------------------------------------------------- #
def _jax_stub(meta_bn, observed, latent, key):
    return {"mu": 0.5 * latent["mu"] + 0.25 * jnp.mean(observed["y"], -1)}


def _port_stub(meta_bn, observed, latent, key):
    return {"mu": 0.5 * latent["mu"] + 0.25 * torch.mean(observed["y"], -1)}


@pytest.mark.parametrize("n_iters,n_chains,n_mc", [(40, 16, 500),
                                                    (7, 3, 11)])
def test_geweke_arithmetic_matches_jax(n_iters, n_chains, n_mc):
    key = jax.random.PRNGKey(9)
    want = jax_geweke_test(jax_conjugate_model(), _jax_stub, ["mu"], ["y"],
                           key, n_iters=n_iters, n_chains=n_chains,
                           n_mc=n_mc)
    key_mc, key_init, key_scan = jax.random.split(key, 3)
    names = ["mu", "y"]
    eps = []
    for k in jax.random.split(key_scan, n_iters):
        k_data, _ = jax.random.split(k)
        k_y = jax.random.fold_in(k_data, zlib.crc32(b"y"))
        eps.append(np.asarray(jax.random.normal(k_y, (n_chains, 3),
                                                jnp.float64)))
    noise = {
        "mc": _jax_joint_draws(jax_conjugate_model(), names, key_mc, n_mc),
        "init": _jax_joint_draws(jax_conjugate_model(), names, key_init,
                                 n_chains),
        "data": {"y": torch.as_tensor(np.stack(eps))},
    }
    got = geweke_test(conjugate_model(), _port_stub, ["mu"], ["y"],
                      n_iters=n_iters, n_chains=n_chains, n_mc=n_mc,
                      noise=noise)
    assert isinstance(got, GewekeResult)
    assert set(got.z_scores) == set(want.z_scores) == {
        "mean[mu]", "m2[mu]", "cross[mu,y]"}
    for field in ("z_scores", "mc_means", "sc_means"):
        for name, v in getattr(want, field).items():
            np.testing.assert_allclose(getattr(got, field)[name], v,
                                       rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got.max_abs_z, want.max_abs_z, rtol=1e-12)
    assert (got.n_mc, got.n_chains, got.n_iters) == (n_mc, n_chains,
                                                      n_iters)


class _JaxStubKernel:
    """A deterministic 'sampler': draws spread around the conjugate
    posterior mean of each sim, the same numbers in both packages."""

    def init(self, theta, n_chain_dims=1):
        return theta

    def run(self, meta_bn, observed, state, key, n_iters, n_adapt=0,
            collect=True, collect_fields=("samples",), thinning=1):
        if not collect:
            return state, None
        n = n_iters // thinning
        post = jnp.sum(observed["y"], -1) / (N_OBS + 1.0)
        offs = jnp.linspace(-1.2, 1.3, n, dtype=jnp.float64)
        return state, {"samples": {"mu": post[None] + 0.41 * offs[:, None]
                                   + 0.01 * state["mu"][None]}}


class _PortStubKernel:
    def init(self, theta, n_chain_dims=1):
        return theta

    def run(self, meta_bn, observed, state, key, n_iters, n_adapt=0,
            collect=True, collect_fields=("samples",), thinning=1):
        if not collect:
            return state, None
        n = n_iters // thinning
        post = torch.sum(observed["y"], -1) / (N_OBS + 1.0)
        offs = torch.as_tensor(np.linspace(-1.2, 1.3, n))
        return state, {"samples": {"mu": post[None] + 0.41 * offs[:, None]
                                   + 0.01 * state["mu"][None]}}


@pytest.mark.parametrize("n_sims,n_draws,n_bins,stat", [
    (256, 63, 16, None), (64, 15, 4, "cube")])
def test_sbc_arithmetic_matches_jax(n_sims, n_draws, n_bins, stat):
    key = jax.random.PRNGKey(13)
    jax_stats = port_stats = None
    if stat == "cube":
        jax_stats = {"cube": lambda v: jnp.asarray(v["mu"]) ** 3}
        port_stats = {"cube": lambda v: torch.as_tensor(v["mu"]) ** 3}
    want = jax_sbc_test(jax_sbc_model(), _JaxStubKernel(), ["mu"], ["y"],
                        key, n_sims=n_sims, n_draws=n_draws, thinning=3,
                        n_warmup=5, n_bins=n_bins, statistics=jax_stats)
    key_joint, _, _ = jax.random.split(key, 3)
    noise = {"joint": _jax_joint_draws(jax_sbc_model(), ["mu", "y"],
                                       key_joint, n_sims)}
    got = sbc_test(sbc_model(), _PortStubKernel(), ["mu"], ["y"],
                   n_sims=n_sims, n_draws=n_draws, thinning=3, n_warmup=5,
                   n_bins=n_bins, statistics=port_stats, noise=noise)
    assert isinstance(got, SBCResult)
    assert set(got.ranks) == set(want.ranks)
    for name in want.ranks:
        np.testing.assert_array_equal(got.ranks[name],
                                      np.asarray(want.ranks[name]))
        np.testing.assert_array_equal(got.histograms[name],
                                      np.asarray(want.histograms[name]))
        np.testing.assert_allclose(got.p_values[name], want.p_values[name],
                                   rtol=1e-12, atol=1e-300)
    assert got.min_p_value == pytest.approx(want.min_p_value, rel=1e-12)
    assert (got.n_sims, got.n_draws, got.expected_per_bin) == (
        want.n_sims, want.n_draws, want.expected_per_bin)


def test_default_batteries_match_jax():
    """The default statistics on one value dict, at 1e-12."""
    from zhusuan_tpu.testing import _default_statistics as jax_battery
    from zhusuan_tpu_torch.testing import _default_statistics as battery

    rng = np.random.RandomState(0)
    vals = {"mu": rng.randn(7, 4, 2), "y": rng.randn(7, 3), "s": rng.randn(7)}
    want = jax_battery(["mu", "s"], ["y"])
    got = battery(["mu", "s"], ["y"])
    assert list(got) == list(want)
    for name, fn in want.items():
        np.testing.assert_allclose(
            got[name]({k: torch.as_tensor(v) for k, v in vals.items()}),
            np.asarray(fn({k: jnp.asarray(v) for k, v in vals.items()})),
            rtol=1e-12)


def test_joint_draws_are_one_batch_of_independent_draws():
    """The port's own joint draws: the model's marginals, and one draw per
    row (not one draw broadcast)."""
    from zhusuan_tpu_torch.testing import _joint_draws

    vals = _joint_draws(conjugate_model(), ["mu", "y"], (3, 4), 20000,
                        "cpu")
    assert vals["mu"].shape == (20000,) and vals["y"].shape == (20000, 3)
    assert abs(float(vals["mu"].std()) - 1.0) < 0.03
    resid = vals["y"] - vals["mu"][:, None]
    assert abs(float(resid.std()) - SIGMA) < 0.02
    assert len(torch.unique(vals["mu"])) == 20000


# --------------------------------------------------------------------- #
# Geweke verdicts (tests/test_geweke.py), the port's own draws
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kernel,seed,n_iters", [
    (lambda: zt.HMC(step_size=0.25, n_leapfrogs=5), 0, 2000),
    (lambda: zt.NUTS(step_size=0.4, max_tree_depth=5), 7, 2000),
    (lambda: zt.RandomWalkMetropolis(step_size=0.6), 1, 3000),
    (lambda: zt.SliceSampler(width=2.0), 11, 2000),
    (lambda: zt.MALA(step_size=0.3), 2, 3000),
], ids=["hmc", "nuts", "rwm", "slice", "mala"])
def test_geweke_correct_kernels_pass(kernel, seed, n_iters):
    res = geweke_test(conjugate_model(), kernel(), latent=["mu"],
                      data=["y"], key=_gen(2024 + seed), n_iters=n_iters,
                      n_chains=64, n_mc=100_000)
    assert res.max_abs_z < 5.0, res.z_scores
    assert set(res.z_scores) == {"mean[mu]", "m2[mu]", "cross[mu,y]"}


def test_geweke_adapted_hmc_is_frozen():
    """An adaptive HMC runs with every adaptation channel off: the step
    size never moves, and the test passes."""
    hmc = zt.HMC(step_size=0.25, n_leapfrogs=5, adapt_step_size=True,
                 adapt_mass=True)
    res = geweke_test(conjugate_model(), hmc, ["mu"], ["y"], key=_gen(5),
                      n_iters=500, n_chains=64, n_mc=20_000)
    assert res.max_abs_z < 5.0, res.z_scores


def test_geweke_detects_unadjusted_langevin():
    """ULA (MALA without the MH correction) at a coarse step size is a
    biased kernel; the test must flag it loudly."""
    eps = 0.8

    def ula(meta_bn, observed, latent, key):
        log_post = make_log_joint_fn(meta_bn, observed)
        grads = make_grad_fn(log_post)(latent)
        gen = iteration_generator(key, 0)
        return {k: latent[k] + 0.5 * eps ** 2 * grads[k]
                + eps * torch.randn(v.shape, generator=gen, dtype=v.dtype)
                for k, v in latent.items()}

    res = geweke_test(conjugate_model(), ula, latent=["mu"], data=["y"],
                      key=_gen(3), n_iters=2000, n_chains=64, n_mc=100_000)
    assert res.max_abs_z > 8.0, res.z_scores


def test_geweke_discrete_gibbs_passes():
    """``tests/test_discrete_gibbs.py::test_geweke_discrete_kernel``."""

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        x = bn.bernoulli("x", torch.tensor(np.log(0.3 / 0.7)),
                         dtype=F64)
        bn.normal("y", x.tensor * 1.0, std=0.8)
        return bn

    res = geweke_test(
        model(), zt.DiscreteGibbs({"x": torch.tensor([0.0, 1.0], dtype=F64)}),
        latent=["x"], data=["y"], key=_gen(3), n_iters=2000, n_chains=64,
        n_mc=100_000)
    assert res.max_abs_z < 5.0, res.z_scores


def test_geweke_rejects_wrong_node_split():
    with pytest.raises(ValueError, match="cover"):
        geweke_test(conjugate_model(), zt.HMC(step_size=0.2),
                    latent=["mu", "ghost"], data=[], key=_gen(0))


def test_geweke_rejects_unknown_kernel():
    with pytest.raises(TypeError, match="kernel must be"):
        geweke_test(conjugate_model(), object(), ["mu"], ["y"], key=_gen(0),
                    n_iters=2, n_chains=2, n_mc=4)


# --------------------------------------------------------------------- #
# SBC verdicts (tests/test_sbc.py)
# --------------------------------------------------------------------- #
def test_sbc_calibrated_hmc_passes():
    res = sbc_test(
        sbc_model(),
        zt.HMC(step_size=0.3, n_leapfrogs=8, adapt_step_size=True),
        latent=["mu"], data=["y"], key=_gen(3),
        n_sims=256, n_draws=63, thinning=8, n_warmup=200)
    assert res.min_p_value > 1e-3, res.p_values
    assert set(res.ranks) == {"mean[mu]", "m2[mu]"}
    assert res.ranks["mean[mu]"].shape == (256,)
    assert res.ranks["mean[mu]"].min() >= 0
    assert res.ranks["mean[mu]"].max() <= 63
    assert res.histograms["mean[mu]"].sum() == 256
    assert res.expected_per_bin == 16.0


def test_sbc_sticky_chain_is_flagged():
    res = sbc_test(sbc_model(), zt.HMC(step_size=1e-4, n_leapfrogs=1),
                   latent=["mu"], data=["y"], key=_gen(4), n_sims=256,
                   n_draws=63, thinning=1, n_warmup=0)
    assert res.min_p_value < 1e-6, res.p_values


def test_sbc_node_coverage_validated():
    with pytest.raises(ValueError, match="cover"):
        sbc_test(sbc_model(), zt.HMC(step_size=0.1, n_leapfrogs=2),
                 latent=["mu"], data=[], key=_gen(0), n_sims=8, n_draws=7,
                 n_bins=8)


def test_sbc_bin_divisibility_validated():
    with pytest.raises(ValueError, match="divisible"):
        sbc_test(sbc_model(), zt.HMC(step_size=0.1, n_leapfrogs=2),
                 latent=["mu"], data=["y"], key=_gen(0), n_sims=8,
                 n_draws=10, n_bins=16)


def test_sbc_custom_statistic_and_nuts():
    res = sbc_test(
        sbc_model(),
        zt.NUTS(step_size=0.3, max_tree_depth=5, adapt_step_size=True),
        latent=["mu"], data=["y"], key=_gen(5), n_sims=128, n_draws=31,
        thinning=4, n_warmup=150, n_bins=8,
        statistics={"mu": lambda v: torch.as_tensor(v["mu"])})
    assert set(res.ranks) == {"mu"}
    assert res.min_p_value > 1e-3, res.p_values


def test_testing_module_exported():
    assert zt.testing.geweke_test is geweke_test
    assert zt.testing.sbc_test is sbc_test
