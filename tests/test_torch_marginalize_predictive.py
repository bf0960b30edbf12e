"""Parity tests of the port's ``marginalize`` and ``posterior_predictive``
(``zhusuan_tpu_torch/framework/{marginalize,predictive}.py``) against the
JAX package's, on the CPU in float64.

- ``marginalize``: the enumerated log-joint of a three-component Gaussian
  mixture against the direct mixture density and the JAX package's
  enumeration (1e-12), a two-site product against a hand logsumexp, a
  vector-valued (one-hot) support, a raw log-joint callable, chain-shaped
  inputs, gradients (1e-10), and every check and message of the JAX
  function;
- ``posterior_predictive``: shapes and default outputs as the JAX
  package's, deterministic outputs at each draw against the JAX package's
  (1e-12), the predictive statistics of the JAX tests (the samples follow
  the port's own generators, one key a draw), one key reproducing and two
  differing, the checks, and the HMC -> predictive loop of the JAX tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu_torch.framework.predictive import draw_key

torch.set_num_threads(1)

W = np.array([0.2, 0.5, 0.3])
MU_NP = np.array([-3.0, 0.5, 4.0])
SD_NP = np.array([0.6, 1.0, 2.0])
LOGITS, MU, SD = (torch.tensor(np.log(W)), torch.tensor(MU_NP),
                  torch.tensor(SD_NP))
JLOGITS, JMU, JSD = jnp.log(jnp.asarray(W)), jnp.asarray(MU_NP), \
    jnp.asarray(SD_NP)


@zt.meta_bayesian_net()
def gmm_model():
    bn = zt.BayesianNet()
    z = bn.categorical("z", LOGITS)
    bn.normal("x", MU[z.tensor], std=SD[z.tensor])
    return bn


@zs.meta_bayesian_net()
def jgmm_model():
    bn = zs.BayesianNet()
    z = bn.categorical("z", JLOGITS)
    bn.normal("x", JMU[z.tensor], std=JSD[z.tensor])
    return bn


def _f64(x):
    return torch.tensor(x, dtype=torch.float64)


def _mixture_logpdf(x):
    x = np.asarray(x, np.float64)[..., None]
    return np.logaddexp.reduce(
        np.log(W) + stats.norm.logpdf(x, MU_NP, SD_NP), axis=-1)


@pytest.mark.parametrize("x", list(np.linspace(-5.0, 7.0, 7)))
def test_matches_mixture_density_and_jax(x):
    lm = zt.marginalize(gmm_model(), {"z": 3})
    jlm = zs.marginalize(jgmm_model(), {"z": 3})
    got = lm({"x": torch.tensor(x)})
    np.testing.assert_allclose(float(got), _mixture_logpdf(x), rtol=1e-12)
    np.testing.assert_allclose(float(got), float(jlm({"x": jnp.asarray(x)})),
                               rtol=1e-12)


def test_two_sites_product():
    la = torch.log(torch.tensor([0.4, 0.6], dtype=torch.float64))
    lb = torch.log(torch.tensor([0.1, 0.2, 0.7], dtype=torch.float64))
    shift = torch.tensor([0.0, 2.0], dtype=torch.float64)
    scale = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)

    @zt.meta_bayesian_net()
    def model():
        bn = zt.BayesianNet()
        a = bn.categorical("a", la)
        b = bn.categorical("b", lb)
        bn.normal("x", shift[a.tensor], std=scale[b.tensor])
        return bn

    lm = zt.marginalize(model(), {"a": 2, "b": 3})
    x = 1.1
    hand = np.logaddexp.reduce([
        float(la[i]) + float(lb[j])
        + stats.norm.logpdf(x, float(shift[i]), float(scale[j]))
        for i in range(2) for j in range(3)])
    np.testing.assert_allclose(float(lm({"x": _f64(x)})), hand, rtol=1e-12)


def test_vector_valued_support():
    """A one-hot support array [K, K] drives a OnehotCategorical site."""
    onehots = torch.eye(3, dtype=torch.float64)

    @zt.meta_bayesian_net()
    def model():
        bn = zt.BayesianNet()
        z = bn.onehot_categorical("z", LOGITS, dtype=torch.float64)
        bn.normal("x", torch.sum(z.tensor * MU, -1),
                  std=torch.sum(z.tensor * SD, -1))
        return bn

    lm = zt.marginalize(model(), {"z": onehots})
    np.testing.assert_allclose(float(lm({"x": _f64(0.7)})),
                               _mixture_logpdf(0.7), rtol=1e-12)


def test_raw_log_joint_callable():
    def lj(obs):
        z, x = obs["z"], obs["x"]
        return (torch.log_softmax(LOGITS, -1)[z]
                + zt.distributions.Normal(MU[z], std=SD[z]).log_prob(x))

    lm = zt.marginalize(lj, {"z": 3})
    np.testing.assert_allclose(float(lm({"x": _f64(-1.0)})),
                               _mixture_logpdf(-1.0), rtol=1e-12)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_every_site_enumerated(device):
    """With every latent enumerated, ``observed`` is empty and names no
    device: int supports made on the host must still score against
    parameters on ``device``. The marginal of the whole joint is log 1 = 0,
    as the JAX package's is; a one-hot support given as a tensor on
    ``device`` takes the same route."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    logits = LOGITS.to(device)
    onehots = torch.eye(3, dtype=torch.float64, device=device)

    @zt.meta_bayesian_net()
    def model():
        bn = zt.BayesianNet()
        bn.categorical("z", logits)
        bn.bernoulli("b", logits[1] - logits[2])
        bn.onehot_categorical("o", logits, dtype=torch.float64)
        return bn

    @zs.meta_bayesian_net()
    def jmodel():
        bn = zs.BayesianNet()
        bn.categorical("z", JLOGITS)
        bn.bernoulli("b", JLOGITS[1] - JLOGITS[2])
        bn.onehot_categorical("o", JLOGITS, dtype=jnp.float64)
        return bn

    lp = zt.marginalize(model(), {"z": 3, "b": 2, "o": onehots})({})
    jlp = zs.marginalize(jmodel(), {"z": 3, "b": 2,
                                    "o": jnp.eye(3, dtype=jnp.float64)})({})
    assert lp.device.type == device
    np.testing.assert_allclose(float(lp), 0.0, atol=1e-12)
    np.testing.assert_allclose(float(lp), float(jlp), atol=1e-12)


def test_chain_axes_broadcast():
    """[C]-shaped continuous latents give a [C]-shaped log density."""
    lm = zt.marginalize(gmm_model(), {"z": 3})
    jlm = zs.marginalize(jgmm_model(), {"z": 3})
    xs = np.linspace(-2, 2, 16)
    lp = lm({"x": torch.tensor(xs)})
    assert tuple(lp.shape) == (16,)
    np.testing.assert_allclose(lp.numpy(), _mixture_logpdf(xs), rtol=1e-12)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlm(
        {"x": jnp.asarray(xs)})), rtol=1e-12)


def test_gradients_flow():
    lm = zt.marginalize(gmm_model(), {"z": 3})
    x = torch.tensor([1.0, -2.5], dtype=torch.float64, requires_grad=True)
    lm({"x": x}).sum().backward()
    jlm = zs.marginalize(jgmm_model(), {"z": 3})
    jg = jax.grad(lambda v: jnp.sum(jlm({"x": v})))(jnp.asarray([1.0,
                                                                -2.5]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-10)


def test_validation():
    lm = zt.marginalize(gmm_model(), {"z": 3})
    with pytest.raises(ValueError, match="marginalized out"):
        lm({"z": torch.tensor(0), "x": torch.tensor(0.0)})
    with pytest.raises(ValueError, match="at least one"):
        zt.marginalize(gmm_model(), {})
    with pytest.raises(ValueError, match=">= 1"):
        zt.marginalize(gmm_model(), {"z": 0})
    with pytest.raises(ValueError, match="leading enumeration axis"):
        zt.marginalize(gmm_model(), {"z": torch.tensor(1.0)})
    with pytest.raises(TypeError, match="MetaBayesianNet"):
        zt.marginalize(42, {"z": 3})


# --------------------------------------------------------------------- #
# posterior_predictive
# --------------------------------------------------------------------- #
def _model(n_data=6):
    @zt.meta_bayesian_net()
    def model():
        bn = zt.BayesianNet()
        mu = bn.normal("mu", torch.tensor(0.0, dtype=torch.float64),
                       std=torch.tensor(10.0, dtype=torch.float64))
        mean = bn.deterministic("mean", mu.tensor * torch.ones(
            n_data, dtype=torch.float64) + 0.5 * torch.sin(mu.tensor))
        bn.normal("x", mean, std=torch.tensor(0.5, dtype=torch.float64),
                  group_ndims=1)
        return bn

    return model()


def _jmodel(n_data=6):
    @zs.meta_bayesian_net()
    def model():
        bn = zs.BayesianNet()
        mu = bn.normal("mu", jnp.float64(0.0), std=jnp.float64(10.0))
        mean = bn.deterministic("mean", mu.tensor * jnp.ones(n_data)
                                + 0.5 * jnp.sin(mu.tensor))
        bn.normal("x", mean, std=jnp.float64(0.5), group_ndims=1)
        return bn

    return model()


def test_shapes_default_outputs_and_deterministic_outputs_match_jax():
    mu = np.array([1.0, 2.0, 3.0, 4.0])
    pred = zt.posterior_predictive(_model(), {"mu": torch.tensor(mu)}, 0)
    jpred = zs.framework.posterior_predictive(
        _jmodel(), {"mu": jnp.asarray(mu)}, jax.random.PRNGKey(0))
    assert set(pred) == set(jpred) == {"x"}
    assert tuple(pred["x"].shape) == tuple(jpred["x"].shape) == (4, 6)
    outs = ["mean", "x"]
    pred = zt.posterior_predictive(_model(), {"mu": torch.tensor(mu)}, 0,
                                   outputs=outs)
    jpred = zs.framework.posterior_predictive(
        _jmodel(), {"mu": jnp.asarray(mu)}, jax.random.PRNGKey(0),
        outputs=outs)
    np.testing.assert_allclose(pred["mean"].numpy(),
                               np.asarray(jpred["mean"]), rtol=1e-12,
                               atol=1e-12)
    assert tuple(pred["x"].shape) == tuple(jpred["x"].shape)


def test_one_key_reproduces_and_draws_differ():
    draws = {"mu": torch.zeros(5, dtype=torch.float64)}
    a = zt.posterior_predictive(_model(), draws, 7)["x"]
    b = zt.posterior_predictive(_model(), draws, 7)["x"]
    c = zt.posterior_predictive(_model(), draws, 8)["x"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    # one generator a draw: the rows differ although the draws agree
    assert len({tuple(r.tolist()) for r in a}) == 5
    assert len({draw_key(7, i) for i in range(1000)}) == 1000


def test_predictive_distribution_statistics():
    """x | mu ~ N(mu + 0.5 sin(mu), 0.5): at a fixed mu the pooled mean
    and std follow."""
    mu = torch.full((4000,), 2.0, dtype=torch.float64)
    x = zt.posterior_predictive(_model(n_data=8), {"mu": mu}, 1)["x"]
    assert abs(float(x.mean()) - (2.0 + 0.5 * np.sin(2.0))) < 0.02
    assert abs(float(x.std()) - 0.5) < 0.02


def test_mixes_posterior_uncertainty():
    """With spread mu draws the predictive variance includes the
    posterior's: Var(x) = Var(mu + 0.5 sin mu) + 0.25."""
    rng = np.random.RandomState(0)
    mu = rng.randn(5000) * 1.5
    x = zt.posterior_predictive(_model(n_data=2),
                                {"mu": torch.tensor(mu)}, 2)["x"].numpy()
    expect = np.var(mu + 0.5 * np.sin(mu)) + 0.25
    assert abs(x.var() - expect) < 0.15, (x.var(), expect)


def test_explicit_outputs_and_validation():
    draws = {"mu": torch.zeros(3, dtype=torch.float64)}
    pred = zt.posterior_predictive(_model(), draws, 0, outputs=["x"])
    assert pred["x"].shape[0] == 3
    with pytest.raises(TypeError, match="MetaBayesianNet"):
        zt.posterior_predictive(lambda o: 0.0, draws, 0)
    with pytest.raises(ValueError, match="at least one"):
        zt.posterior_predictive(_model(), {}, 0)
    with pytest.raises(ValueError, match="leading n_draws axis"):
        zt.posterior_predictive(
            _model(), {"mu": torch.zeros(3), "x": torch.zeros(4, 6)}, 0)
    with pytest.raises(ValueError, match="No stochastic nodes"):
        zt.posterior_predictive(
            _model(), {"mu": torch.zeros(3, dtype=torch.float64),
                       "x": torch.zeros(3, 6, dtype=torch.float64)}, 0)


def test_end_to_end_with_hmc():
    """HMC posterior -> predictive -> the held-out data's mean."""
    model = _model(n_data=10)
    x_obs = torch.tensor(np.full(10, 1.8)
                         + 0.5 * np.random.RandomState(3).randn(10))

    def log_joint(obs):
        mu = obs["mu"]
        m = mu[..., None] + 0.5 * torch.sin(mu)[..., None]
        return (-0.5 * (mu / 10.0) ** 2
                + torch.sum(-0.5 * ((x_obs - m) / 0.5) ** 2, dim=-1))

    hmc = zt.HMC(step_size=0.1, n_leapfrogs=8, adapt_step_size=True)
    state = hmc.init({"mu": torch.zeros(16, dtype=torch.float64)},
                     n_chain_dims=1)
    _, out = hmc.run(log_joint, {}, state, torch.Generator().manual_seed(4),
                     800, n_adapt=400, collect_fields=("samples",))
    mu_draws = out["samples"]["mu"][400:].reshape(-1)
    x = zt.posterior_predictive(model, {"mu": mu_draws}, 5)["x"]
    assert abs(float(x.mean()) - float(x_obs.mean())) < 0.1
