"""Parity tests of zhusuan_tpu_torch/variational/advi.py (one-call ADVI)
against the JAX package, on the CPU.

The plain loop is held to the JAX package's ``lax.scan`` path in float64 at
1e-8 over 30 steps: the JAX path draws step ``t``'s normals from
``split(key, n_iters)[t]`` (``advi.py:133-136``), which the mean-field guide
splits again per latent in sorted-name order (``autoguide.py:247-253``) and
the full-rank guide uses as it is (``:319-321``); the tests rebuild those
draws and feed them to the port through ``noise=`` (flat ``[n_iters, n, D]``,
sorted-name blocks). Both start from ``init_params()`` or from the same numpy
parameters (``params_from_numpy``), and run Adam under the same schedule
(``cosine_decay_schedule`` against optax's at 1e-12).

The slice as a whole: the JAX ``advi(..., experimental_fused=True,
_fused_interpret=True, _fused_noise=noise)`` on the two-node toy2d model (the
Pallas kernel in interpret mode) against the port's ``advi(Toy2DLogJoint,
experimental_fused=True, noise=noise)`` on the CPU (the CUDA trainer's plain
version), 60 steps in float32 at rtol 1e-4 on ``loc``, ``log_scale`` and
``losses``. Routing and messages are held as in ``tests/test_ops_advi.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
import zhusuan_tpu_torch as zt
from zhusuan_tpu_torch.ops import advi_step
from zhusuan_tpu_torch.variational import (
    ADVIResult,
    FullRankGuide,
    MeanFieldGuide,
    advi,
    cosine_decay_schedule,
    params_from_numpy,
    params_to_numpy,
)

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
F64 = jnp.float64
PLAIN_TOL = 1e-8  # 30 Adam steps in float64
FUSED_RTOL = 1e-4  # 60 steps in float32, kernel arithmetic on both sides


def _t(x, dtype=torch.float64):
    return torch.tensor(np.array(x), dtype=dtype)


def _close(got, want, rtol, atol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol if atol is None else atol)


# --------------------------------------------------------------------- #
# The schedule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("init,steps,alpha", [
    (1e-2, 2000, 0.1), (0.05, 30, 0.1), (0.3, 7, 0.0), (1.0, 1, 1e-3)])
def test_cosine_schedule_matches_optax(init, steps, alpha):
    ours = cosine_decay_schedule(init, steps, alpha)
    theirs = optax.cosine_decay_schedule(init, steps, alpha)
    for t in list(range(0, steps + 3)) + [10 * steps]:
        np.testing.assert_allclose(ours(t), float(theirs(jnp.asarray(t))),
                                   rtol=1e-12, atol=1e-15)
    assert ours(0) == init
    with pytest.raises(ValueError, match="decay_steps must be positive"):
        cosine_decay_schedule(init, 0)


# --------------------------------------------------------------------- #
# The plain loop against the JAX scan path, float64
# --------------------------------------------------------------------- #
@zs.meta_bayesian_net()
def j_conjugate(x_obs):
    bn = zs.BayesianNet()
    w = bn.normal("w", jnp.zeros(2), std=F64(1.0), group_ndims=1)
    bn.normal("x", jnp.sum(w.tensor, axis=-1, keepdims=True), std=F64(1.0),
              group_ndims=1)
    return bn


@zt.meta_bayesian_net()
def t_conjugate(x_obs):
    bn = zt.BayesianNet()
    w = bn.normal("w", torch.zeros(2, dtype=torch.float64), std=_t(1.0),
                  group_ndims=1)
    bn.normal("x", torch.sum(w.tensor, dim=-1, keepdim=True), std=_t(1.0),
              group_ndims=1)
    return bn


@zs.meta_bayesian_net()
def j_mixed():
    bn = zs.BayesianNet()
    a = bn.normal("a", jnp.zeros(2), std=F64(1.0), group_ndims=1)
    tau = bn.gamma("tau", F64(3.0), beta=F64(2.0))
    w = bn.normal("w", jnp.zeros((2, 3)), std=F64(2.0), group_ndims=2)
    mean = jnp.sum(a.tensor, -1) + jnp.sum(w.tensor, (-1, -2))
    bn.normal("x", mean, std=1.0 / jnp.sqrt(tau.tensor))
    return bn


@zt.meta_bayesian_net()
def t_mixed():
    bn = zt.BayesianNet()
    a = bn.normal("a", torch.zeros(2, dtype=torch.float64), std=_t(1.0),
                  group_ndims=1)
    tau = bn.gamma("tau", _t(3.0), _t(2.0))
    w = bn.normal("w", torch.zeros(2, 3, dtype=torch.float64), std=_t(2.0),
                  group_ndims=2)
    mean = torch.sum(a.tensor, -1) + torch.sum(w.tensor, (-1, -2))
    bn.normal("x", mean, std=1.0 / torch.sqrt(tau.tensor))
    return bn


X = np.asarray([1.2])
MODELS = {
    "conjugate": (lambda: j_conjugate(jnp.asarray(X)),
                  lambda: t_conjugate(_t(X)), {"x": X}),
    "mixed": (j_mixed, t_mixed, {"x": np.asarray(0.7)}),
}


def _jax_noise(jguide, guide, key, n_iters, n):
    """The flat ``[n_iters, n, D]`` normals of the JAX scan path: step t
    draws from ``split(key, n_iters)[t]``, split again per latent by the
    mean-field guide."""
    out = []
    for k in jax.random.split(key, n_iters):
        if guide == "fullrank":
            out.append(np.asarray(jax.random.normal(
                k, (n, jguide._dim), jguide._dtype)))
            continue
        subs = jax.random.split(k, len(jguide.latent_names))
        out.append(np.concatenate([
            np.asarray(jax.random.normal(
                s, (n,) + jguide._shapes[name],
                jguide._dtypes[name])).reshape(n, -1)
            for name, s in zip(jguide.latent_names, subs)], axis=1))
    return np.stack(out)


@pytest.mark.parametrize("guide", ["meanfield", "fullrank"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_loop_matches_jax_scan_path(model, guide):
    jm, tm, obs = MODELS[model]
    n_iters, n = 30, 8
    kw = dict(guide=guide, n_iters=n_iters, n_samples=n, learning_rate=0.05)
    jres = zs.variational.advi(
        jm(), {k: jnp.asarray(v) for k, v in obs.items()}, KEY,
        experimental_fused=False, **kw)
    noise = _jax_noise(jres.guide, guide, KEY, n_iters, n)
    tres = advi(tm(), {k: _t(v) for k, v in obs.items()}, None,
                noise=_t(noise), **kw)
    assert isinstance(tres, ADVIResult)
    assert tres.losses.shape == (n_iters,)
    assert tres.losses.dtype == torch.float64
    _close(tres.losses, jres.losses, PLAIN_TOL)
    got = params_to_numpy(tres.params)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jres.params))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jres.params)):
        _close(a, b, PLAIN_TOL)
    for leaf in jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda v: v.requires_grad, tres.params)):
        assert not leaf


def test_plain_loop_from_shared_params_and_a_schedule():
    """``init_params`` carried across by ``params_from_numpy``, a constant
    rate given as ``lr_schedule``, a guide instance passed in."""
    jm, tm, obs = MODELS["mixed"]
    n_iters, n = 30, 8
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: _t(v) for k, v in obs.items()}
    jg = zs.variational.MeanFieldGuide(jm(), observed=jobs)
    tg = MeanFieldGuide(tm(), observed=tobs)
    rng = np.random.RandomState(1)
    init = jax.tree_util.tree_map(lambda v: 0.3 * rng.randn(*v.shape),
                                  jg.init_params())
    jres = zs.variational.advi(
        jm(), jobs, KEY, guide=jg, n_iters=n_iters, n_samples=n,
        init_params=jax.tree_util.tree_map(jnp.asarray, init),
        lr_schedule=lambda t: 0.1, experimental_fused=False)
    noise = _jax_noise(jg, "meanfield", KEY, n_iters, n)
    tinit = params_from_numpy(tg, init)
    before = params_to_numpy(tinit)
    tres = advi(tm(), tobs, None, guide=tg, n_iters=n_iters, n_samples=n,
                init_params=tinit, lr_schedule=lambda t: 0.1,
                noise=_t(noise))
    assert tres.guide is tg
    _close(tres.losses, jres.losses, PLAIN_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(tres.params)),
                    jax.tree_util.tree_leaves(jres.params)):
        _close(a, b, PLAIN_TOL)
    # The caller's tensors are copied, never updated in place.
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(tinit)),
                    jax.tree_util.tree_leaves(before)):
        assert np.array_equal(a, b)


def test_custom_optimizer_matches_optax_sgd():
    jm, tm, obs = MODELS["conjugate"]
    n_iters, n = 10, 8
    jres = zs.variational.advi(
        jm(), {k: jnp.asarray(v) for k, v in obs.items()}, KEY,
        n_iters=n_iters, n_samples=n, optimizer=optax.sgd(0.02))
    noise = _jax_noise(jres.guide, "meanfield", KEY, n_iters, n)
    tres = advi(tm(), {k: _t(v) for k, v in obs.items()}, None,
                n_iters=n_iters, n_samples=n, noise=_t(noise),
                optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.02))
    _close(tres.losses, jres.losses, PLAIN_TOL)
    _close(tres.params["loc"]["w"], jres.params["loc"]["w"], PLAIN_TOL)


# --------------------------------------------------------------------- #
# The slice as a whole: the fused fit, float32
# --------------------------------------------------------------------- #
@zs.meta_bayesian_net()
def j_toy2d():
    """examples/toy_examples/toy2d_intractable.py's model, two nodes."""
    bn = zs.BayesianNet()
    z2 = bn.normal("z2", 0.0, std=1.35)
    bn.normal("z1", 0.0, logstd=z2.tensor)
    return bn


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_fused_fit_matches_the_pallas_kernel_in_interpret_mode(schedule):
    n_iters, n = 60, 16
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                         (n_iters, n, 2), jnp.float32))
    jinit = {"loc": {"z1": jnp.float32(-2.0), "z2": jnp.float32(-2.0)},
             "log_scale": {"z1": jnp.float32(-5.0), "z2": jnp.float32(-5.0)}}
    jkw, tkw = {}, {}
    if schedule == "constant":
        jkw["lr_schedule"] = tkw["lr_schedule"] = lambda t: 0.1
    else:
        jkw["learning_rate"] = tkw["learning_rate"] = 0.05
    jres = zs.variational.advi(
        j_toy2d(), {}, KEY, n_iters=n_iters, n_samples=n, init_params=jinit,
        experimental_fused=True, _fused_interpret=True,
        _fused_noise=jnp.asarray(noise), **jkw)
    dens = zt.Toy2DLogJoint("z", 1.35)
    guide = MeanFieldGuide(dens, device="cpu")
    tinit = guide.init_params()
    tinit["loc"]["z"] = torch.full((2,), -2.0)
    tinit["log_scale"]["z"] = torch.full((2,), -5.0)
    tres = advi(dens, {}, None, guide=guide, n_iters=n_iters, n_samples=n,
                init_params=tinit, experimental_fused=True,
                noise=torch.as_tensor(noise), **tkw)
    assert tres.losses.dtype == torch.float32
    assert bool(np.isfinite(np.asarray(jres.losses)).all())
    _close(tres.losses, jres.losses, FUSED_RTOL, 1e-5)
    for kind in ("loc", "log_scale"):
        want = [float(jres.params[kind]["z1"]), float(jres.params[kind]["z2"])]
        _close(tres.params[kind]["z"], want, FUSED_RTOL, 1e-5)
    assert tres.params["loc"]["z"].shape == (2,)


def test_fused_and_plain_paths_share_their_noise_layout():
    """On the CPU the fused fit (the trainer's plain version) and the plain
    loop, fed the same ``noise=``, walk the same trajectory to float32
    rounding: the same estimator, the same Adam."""
    n_iters, n = 40, 32
    dens = zt.DiagonalGaussianLogJoint(
        "z", torch.tensor([2.0, -1.0, 0.5]), torch.tensor([0.5, 1.5, 1.0]))
    noise = torch.as_tensor(np.random.RandomState(2).randn(n_iters, n, 3),
                            dtype=torch.float32)
    kw = dict(n_iters=n_iters, n_samples=n, learning_rate=0.05, noise=noise,
              device="cpu")
    fused = advi(dens, {}, None, experimental_fused=True, **kw)
    plain = advi(dens, {}, None, experimental_fused=False, **kw)
    _close(fused.losses, plain.losses, 1e-4)
    for kind in ("loc", "log_scale"):
        _close(fused.params[kind]["z"], plain.params[kind]["z"], 1e-4)


# --------------------------------------------------------------------- #
# Routing (tests/test_ops_advi.py::TestADVIRouting)
# --------------------------------------------------------------------- #
def _builtin():
    return zt.DiagonalGaussianLogJoint("z", torch.zeros(2), torch.ones(2))


def test_force_with_custom_optimizer_raises():
    with pytest.raises(ValueError, match="default optimizer"):
        advi(_builtin(), {}, (1, 2), n_iters=10, device="cpu",
             experimental_fused=True,
             optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.1))


def test_force_with_fullrank_raises():
    with pytest.raises(ValueError, match="mean-field"):
        advi(_builtin(), {}, (1, 2), n_iters=10, guide="fullrank",
             device="cpu", experimental_fused=True)


def test_force_with_a_meta_bn_raises():
    _, tm, obs = MODELS["conjugate"]
    with pytest.raises(ValueError, match="only the built-in densities"):
        advi(tm(), {k: _t(v) for k, v in obs.items()}, (1, 2), n_iters=10,
             experimental_fused=True)


def test_force_with_a_bijector_raises():
    with pytest.raises(ValueError, match="bijector must be the identity"):
        advi(_builtin(), {}, (1, 2), n_iters=10, device="cpu",
             bijectors={"z": zt.bijectors.Softplus()},
             experimental_fused=True)


def test_force_with_an_unsupported_size_raises():
    with pytest.raises(ValueError, match="unsupported size"):
        advi(_builtin(), {}, (1, 2), n_iters=2 ** 20 + 1, device="cpu",
             experimental_fused=True)


@pytest.mark.parametrize("flag", ["auto", False])
def test_auto_on_cpu_takes_the_plain_loop(flag, monkeypatch):
    """No plain version of the kernel in production use on the CPU."""
    def boom(*a, **k):
        raise AssertionError("the fused trainer ran")

    monkeypatch.setattr(advi_step, "fused_meanfield_advi", boom)
    res = advi(_builtin(), {}, (1, 2), n_iters=20, n_samples=8, device="cpu",
               experimental_fused=flag)
    assert res.losses.shape == (20,) and torch.isfinite(res.losses).all()
    _, tm, obs = MODELS["conjugate"]
    res = advi(tm(), {k: _t(v) for k, v in obs.items()}, (1, 2), n_iters=5,
               n_samples=8, experimental_fused=flag)
    assert res.losses.shape == (5,)


def test_force_on_cpu_runs_the_plain_version_of_the_kernel():
    before = advi_step.fused_meanfield_advi.launches
    res = advi(_builtin(), {}, (1, 2), n_iters=20, n_samples=7, device="cpu",
               experimental_fused=True)
    want = advi_step.fused_meanfield_advi_reference(
        _builtin(), torch.zeros(2), torch.full((2,), float(np.log(0.1))), 20,
        7, (1, 2), cosine_decay_schedule(1e-2, 20, 0.1))
    assert torch.equal(res.params["loc"]["z"], want[0])
    assert torch.equal(res.losses, want[2])
    assert advi_step.fused_meanfield_advi.launches == before


def test_init_params_passthrough():
    _, tm, obs = MODELS["conjugate"]
    tobs = {k: _t(v) for k, v in obs.items()}
    g = MeanFieldGuide(tm(), observed=tobs)
    init = g.init_params()
    init["loc"]["w"] = _t([5.0, -5.0])
    res = advi(tm(), tobs, (1, 2), n_iters=1, n_samples=8,
               learning_rate=1e-3, experimental_fused=False,
               init_params=init)
    # One tiny step: params stay near the custom init.
    _close(res.params["loc"]["w"], [5.0, -5.0], 0.0, 0.1)


def test_guide_argument_is_checked():
    with pytest.raises(ValueError, match="guide must be"):
        advi(_builtin(), {}, (1, 2), guide="banana", device="cpu")


def test_keys():
    """A key pair and a generator to draw one from; one key, one fit."""
    kw = dict(n_iters=5, n_samples=4, device="cpu")
    a = advi(_builtin(), {}, (1, 2), **kw)
    b = advi(_builtin(), {}, (1, 2), **kw)
    c = advi(_builtin(), {}, (1, 3), **kw)
    d = advi(_builtin(), {}, torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a.losses, b.losses)
    assert not torch.equal(a.losses, c.losses)
    assert torch.isfinite(d.losses).all()


# --------------------------------------------------------------------- #
# End to end (tests/variational/test_autoguide.py::TestADVIOneCall)
# --------------------------------------------------------------------- #
def test_advi_recovers_conjugate_posterior():
    sigma, tau = 1.0, 3.0
    y = np.asarray([1.2, 2.1, 1.7, 2.5, 0.9, 1.4, 2.2, 1.8])

    @zt.meta_bayesian_net()
    def model():
        bn = zt.BayesianNet()
        mu = bn.normal("mu", _t(0.0), std=_t(tau))
        mean = mu.tensor[..., None].expand(mu.tensor.shape + (len(y),))
        bn.normal("y", mean, std=_t(sigma), group_ndims=1)
        return bn

    res = advi(model(), {"y": _t(y)}, (0, 0), n_iters=1500, n_samples=64)
    prec = 1 / tau ** 2 + len(y) / sigma ** 2
    post_mean, post_sd = (y.sum() / sigma ** 2) / prec, 1 / np.sqrt(prec)
    draws = res.guide.sample_posterior(res.params, (0, 1), 8000)["mu"]
    assert abs(float(draws.mean()) - post_mean) < 0.05
    assert abs(float(draws.std()) - post_sd) < 0.05
    assert float(res.losses[-1]) < float(res.losses[0])
    assert res.losses.shape == (1500,)


def test_advi_fullrank_recovers_a_correlated_posterior():
    """w | x ~ N(mu, (I + 11^T)^-1): inside the full-rank family."""
    _, tm, obs = MODELS["conjugate"]
    res = advi(tm(), {k: _t(v) for k, v in obs.items()}, (0, 0),
               guide="fullrank", n_iters=1200, n_samples=64,
               learning_rate=0.05)
    assert isinstance(res.guide, FullRankGuide)
    cov = np.linalg.inv(np.eye(2) + np.ones((2, 2)))
    _close(res.guide.covariance(res.params), cov, 0.0, 0.06)
    _close(res.guide.median(res.params)["w"], cov @ (np.ones(2) * X[0]), 0.0,
           0.08)
