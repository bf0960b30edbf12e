"""Tests of three repairs to zhusuan_tpu_torch, each against the JAX package
on the CPU.

1. ``Distribution.log_survival`` and ``Normal._log_survival`` (JAX:
   ``zhusuan_tpu/distributions/base.py:235-251``, ``univariate.py:138-143``):
   float64 parity at 1e-12, tails included.
2. Every sampler's ``sample`` and ``run`` (and ``HMC.make_cache``) name their
   model argument ``meta_bn``, as the JAX package does
   (``zhusuan_tpu/mcmc/hmc.py:405``); ``init`` keeps JAX's ``log_joint=``
   (``hmc.py:204``).
3. The SVGP example accepts ``-dataset diabetes`` (JAX:
   ``examples/gaussian_process/svgp.py:34``), its loader and the other data
   helpers living in ``zhusuan_tpu_torch/examples/utils/dataset.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu_torch import distributions as tdist
from zhusuan_tpu_torch.examples.gaussian_process import svgp
from zhusuan_tpu_torch.examples.utils import dataset

torch.set_num_threads(1)

TOL = 1e-12


def _t(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


# --------------------------------------------------------------------- #
# 1. log_survival
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("param", ["std", "logstd"])
@pytest.mark.parametrize("group_ndims", [0, 1, 2])
def test_normal_log_survival_matches_jax(param, group_ndims):
    rng = np.random.RandomState(0)
    mean, std = rng.randn(3, 5), rng.uniform(0.3, 2.0, (3, 5))
    # z from the bulk out to +-30 standard deviations.
    z = np.concatenate([rng.randn(2, 3, 5) * 2,
                        np.full((1, 3, 5), 30.0), np.full((1, 3, 5), -30.0),
                        np.full((1, 3, 5), 8.5), np.zeros((1, 3, 5))])
    given = mean + std * z
    value = std if param == "std" else np.log(std)
    jd = zs.distributions.Normal(jnp.asarray(mean), group_ndims=group_ndims,
                                 **{param: jnp.asarray(value)})
    td = tdist.Normal(_t(mean), group_ndims=group_ndims,
                      **{param: _t(value)})
    want = np.asarray(jd.log_survival(jnp.asarray(given)))
    got = td.log_survival(_t(given))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.isfinite(got.numpy()).all()
    if group_ndims == 0:
        # z = 30: log ndtr(-30) = -454.3; z = -30: -5e-198, i.e. 0.
        assert float(got[2].max()) < -450.0
        assert float(got[3].abs().max()) < 1e-190


def test_log_survival_is_differentiable_and_complements_the_cdf():
    mean = _t([0.3, -1.0]).requires_grad_(True)
    d = tdist.Normal(mean, std=_t([0.5, 2.0]))
    x = _t([0.9, -2.0])
    ls = d.log_survival(x)
    cdf = 0.5 * (1.0 + torch.erf((x - mean) / (_t([0.5, 2.0]) * 2 ** 0.5)))
    np.testing.assert_allclose(torch.exp(ls).detach().numpy(),
                               (1.0 - cdf).detach().numpy(), rtol=1e-12)
    (g,) = torch.autograd.grad(ls.sum(), mean)
    jd = lambda m: jnp.sum(zs.distributions.Normal(  # noqa: E731
        m, std=jnp.asarray([0.5, 2.0])).log_survival(
            jnp.asarray([0.9, -2.0])))
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jd)(
        jnp.asarray([0.3, -1.0]))), rtol=1e-10)


def test_log_survival_checks_and_default():
    d = tdist.Normal(torch.zeros(3, dtype=torch.float64), std=_t(1.0),
                     group_ndims=1)
    assert d.log_survival(torch.zeros(4, 3, dtype=torch.float64)).shape == (
        4,)
    with pytest.raises(NotImplementedError,
                       match="Gamma does not implement log_survival"):
        tdist.Gamma(_t(2.0), _t(1.0)).log_survival(_t(1.0))


# --------------------------------------------------------------------- #
# 2. meta_bn= by keyword
# --------------------------------------------------------------------- #
def _target():
    return zt.DiagonalGaussianLogJoint("x", torch.zeros(4),
                                       torch.linspace(0.5, 1.5, 4))


SAMPLERS = {
    "HMC": lambda: zt.HMC(step_size=0.2, n_leapfrogs=3),
    "NUTS": lambda: zt.NUTS(step_size=0.2, max_tree_depth=3),
    "ChEESHMC": lambda: zt.ChEESHMC(step_size=0.2),
    "SGLD": lambda: zt.SGLD(learning_rate=0.01),
    "PSGLD": lambda: zt.PSGLD(learning_rate=0.01),
    "SGHMC": lambda: zt.SGHMC(learning_rate=0.01),
    "SGNHT": lambda: zt.SGNHT(learning_rate=0.01),
}
JAX_SAMPLERS = {"HMC": zs.HMC, "NUTS": zs.NUTS, "ChEESHMC": zs.ChEESHMC,
                "SGLD": zs.SGLD, "PSGLD": zs.PSGLD, "SGHMC": zs.SGHMC,
                "SGNHT": zs.SGNHT}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_take_meta_bn_by_keyword(name):
    sampler, dens = SAMPLERS[name](), _target()
    q0 = {"x": torch.zeros(8, 4)}
    if name in ("HMC", "NUTS"):
        state = sampler.init(q0, log_joint=dens)  # JAX's name for init's
    elif name in ("SGHMC", "SGNHT"):
        state = sampler.init(q0, key=(1, 2))
    else:
        state = sampler.init(q0)
    state, info = sampler.sample(meta_bn=dens, observed={}, state=state,
                                 key=(3, 4))[:2]
    state, out = sampler.run(meta_bn=dens, observed={}, state=state,
                             key=(5, 6), n_iters=3)
    # The SGMCMC samplers return the stacked positions themselves.
    draws = (out if name.startswith("SG") or name == "PSGLD"
             else out["samples"])["x"]
    assert draws.shape == (3, 8, 4) and torch.isfinite(draws).all()
    with pytest.raises(TypeError, match="log_joint"):
        sampler.sample(log_joint=dens, observed={}, state=state, key=(3, 4))
    if name == "HMC":
        logp, grad = sampler.make_cache(meta_bn=dens, observed={},
                                        state=state)
        assert logp.shape == (8,) and grad["x"].shape == (8, 4)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("method", ["init", "sample", "run"])
def test_leading_parameter_names_match_jax(name, method):
    """The positional parameters the two packages share carry one name."""
    ours = list(inspect.signature(
        getattr(SAMPLERS[name](), method)).parameters)
    theirs = list(inspect.signature(
        getattr(JAX_SAMPLERS[name], method)).parameters)[1:]  # self
    shared = 4 if method != "init" else 1
    assert ours[:shared] == theirs[:shared], (ours, theirs)
    for kw in ("meta_bn", "log_joint"):
        assert (kw in ours) == (kw in theirs), (kw, ours, theirs)


# --------------------------------------------------------------------- #
# 3. -dataset diabetes
# --------------------------------------------------------------------- #
def test_diabetes_loader_matches_the_jax_examples():
    pytest.importorskip("sklearn")
    from examples.utils import dataset as jdataset

    got = dataset.load_uci_diabetes()
    want = jdataset.load_uci_diabetes()
    assert got[-1] is False and want[-1] is False
    assert got[0].shape == (353, 10) and got[4].shape == (45, 10)
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == np.float64 and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["load_uci_boston_housing",
                                  "load_uci_protein_data"])
def test_moved_loaders_match_the_jax_examples(name, tmp_path, monkeypatch):
    from examples.utils import dataset as jdataset

    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))  # no files: synthetic
    got, want = getattr(dataset, name)(), getattr(jdataset, name)()
    assert got[-1] is True and want[-1] is True
    for a, b in zip(got[:-1], want[:-1]):
        assert np.array_equal(a, b)
    # The SVGP module goes on offering the helpers it used to define.
    assert getattr(svgp, name) is getattr(dataset, name)
    assert svgp.standardize is dataset.standardize
    assert svgp.regression_splits is dataset.regression_splits


def test_diabetes_loader_says_why_without_sklearn(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.split(".")[0] == "sklearn":
            raise ImportError("No module named 'sklearn'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(ImportError, match="ships with scikit-learn"):
        dataset.load_uci_diabetes()


def test_svgp_main_accepts_diabetes(capsys):
    pytest.importorskip("sklearn")
    params = svgp.main(["-dataset", "diabetes", "-n_epoch", "3", "-n_z",
                        "20", "--device", "cpu"])
    assert "synthetic" not in capsys.readouterr().out
    assert params["z_pos"].shape == (20, 10)
    assert all(torch.isfinite(v).all() for v in params.values())
    # Three epochs move the parameters off their init.
    assert float(params["z_mean"].abs().max()) > 0.0
    with pytest.raises(SystemExit):
        svgp.main(["-dataset", "iris", "--device", "cpu"])
