"""Parity of the eight example files of the GP / flow / SVGD / ESS slice
(``zhusuan_tpu_torch/examples/{gaussian_process,normalizing_flows,
stein_variational,toy_examples}/``) with the JAX package's, on the CPU at
small sizes: each file's step, or its ``main`` cut short, on the same
weights and draws (a node's normals from ``fold_in(key, crc32(name))``;
a sampler's from its JAX key schedule), in float64 at 1e-10 a step and
1e-8 over chained steps, and in float32 (``gaussian_chees``, whose JAX
file fixes float32) at 1e-4. Statistical gates belong to ``chip_smoke.py``
phases 29-31."""

import math
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zhusuan_tpu as zs
from examples.gaussian_process import gp_classification_ess as jgce
from examples.gaussian_process import gp_regression_diabetes as jgrd
from examples.normalizing_flows import toy2d_flow as jtf
from examples.normalizing_flows import vae_nf as jnf
from examples.stein_variational import blr_svgd as jbl
from examples.toy_examples import gaussian_chees as jgch
from examples.toy_examples import mixture_sgnht as jms
from examples.toy_examples import neal_funnel_neutra as jfun
from examples.utils import dataset as jdataset
from examples.variational_autoencoders import vae as jvae
from zhusuan_tpu import transform as jt
from zhusuan_tpu.mcmc import base as jbase
from zhusuan_tpu_torch import transform as tt
from zhusuan_tpu_torch.examples.gaussian_process import (
    gp_classification_ess as tgce,
)
from zhusuan_tpu_torch.examples.gaussian_process import (
    gp_regression_diabetes as tgrd,
)
from zhusuan_tpu_torch.examples.normalizing_flows import toy2d_flow as ttf
from zhusuan_tpu_torch.examples.normalizing_flows import vae_nf as tnf
from zhusuan_tpu_torch.examples.stein_variational import blr_svgd as tbl
from zhusuan_tpu_torch.examples.toy_examples import gaussian_chees as tgch
from zhusuan_tpu_torch.examples.toy_examples import mixture_sgnht as tms
from zhusuan_tpu_torch.examples.toy_examples import (
    neal_funnel_neutra as tfun,
)
from zhusuan_tpu_torch.examples.utils import dataset as tdataset
from zhusuan_tpu_torch.examples.utils import nn as tnn
from zhusuan_tpu_torch.mcmc import fit_neutra, neutra_log_joint
from zhusuan_tpu_torch.mcmc import hmc as thmc_mod
from zhusuan_tpu_torch.ops.chees_step import (
    fused_chees_step,
    fused_chees_step_reference,
)
from zhusuan_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)

TOL = 1e-10
TOL_CHAIN = 1e-8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _node_normals(key, name, shape):
    return np.asarray(jax.random.normal(
        jax.random.fold_in(key, zlib.crc32(name.encode())), shape,
        jnp.float64))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# --------------------------------------------------------------------- #
# gaussian_process/gp_regression_diabetes.py
# --------------------------------------------------------------------- #
def test_gp_regression_diabetes_cut_main():
    want_split = jgrd.load_diabetes(0)
    got_split = tgrd.load_diabetes(0)
    for g, w in zip(got_split, want_split):
        np.testing.assert_array_equal(g, w)
    want = jgrd.main(n_iters=6, m_inducing=8, svgp_n_iters=6, verbose=False)
    got = tgrd.run("cpu", n_iters=6, m_inducing=8, svgp_n_iters=6,
                   dtype=torch.float64, verbose=False)
    for g, w in zip(got, want):
        _close(g, w, TOL_CHAIN)


def test_diabetes_arrays_from_npz(tmp_path, monkeypatch):
    path = tmp_path / "diabetes.npz"
    tdataset.save_uci_diabetes(str(path))
    monkeypatch.setenv("ZS_DATA_DIR", str(tmp_path))
    data, target = tdataset.diabetes_arrays()
    assert data.shape == (442, 10) and target.dtype == np.float64
    np.testing.assert_array_equal(tgrd.load_diabetes(0)[0],
                                  jgrd.load_diabetes(0)[0])


# --------------------------------------------------------------------- #
# gaussian_process/gp_classification_ess.py
# --------------------------------------------------------------------- #
def _ess_noise(key, n_chains, d, n_iters, max_shrink=64):
    """The draws of JAX's ``run(key)``: ``k, sub = split(k)`` an iteration,
    then ``sample(sub)``'s four-way split."""
    out, k = [], key
    for _ in range(n_iters):
        k, sub = jax.random.split(k)
        key_nu, key_u, key_theta, key_shrink = jax.random.split(sub, 4)
        nu = jbase.tree_normal_like(key_nu, {"f": jnp.zeros((n_chains, d))})
        u = jax.random.uniform(key_u, (n_chains,), jnp.float64)
        theta = jax.random.uniform(key_theta, (n_chains,), jnp.float64, 0.0,
                                   2.0 * jnp.pi)
        shrink = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(key_shrink, i), (n_chains,), jnp.float64))
            for i in range(max_shrink)])
        out.append(({"f": np.array(nu["f"])}, np.asarray(u),
                    np.asarray(theta), shrink))
    return out


def test_gp_classification_ess_cut_main(monkeypatch):
    n_chains, n_iters, burn_in = 4, 12, 4
    runs = []

    class Recording(jgce.EllipticalSlice):
        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            runs.append(out)
            return out

    # The JAX main jits its run; without jit the outputs can be kept.
    monkeypatch.setattr(jgce, "EllipticalSlice", Recording)
    monkeypatch.setattr(jgce, "jax", types.SimpleNamespace(
        jit=lambda f: f, nn=jax.nn, random=jax.random))
    want_acc, want_base = jgce.main(n_chains=n_chains, n_iters=n_iters,
                                    burn_in=burn_in)
    _, jout = runs[0]
    x, y = tgce.make_data()
    np.testing.assert_array_equal(x, jgce.make_data()[0])
    noise = _ess_noise(jax.random.PRNGKey(1), n_chains, len(x), n_iters)
    acc, base, out = tgce.run("cpu", n_chains, n_iters, burn_in,
                              dtype=torch.float64, noise=noise)
    _close(out["samples"]["f"], jout["samples"]["f"])
    assert out["n_shrinks"].tolist() == \
        np.asarray(jout["n_shrinks"]).tolist()
    assert (acc, base) == (want_acc, want_base)


# --------------------------------------------------------------------- #
# normalizing_flows/toy2d_flow.py
# --------------------------------------------------------------------- #
def _jax_coupling(n_flows=3, hidden=8):
    params = _f64(jt.init_affine_coupling(jax.random.PRNGKey(0), n_flows, 2,
                                          hidden=hidden, dtype=jnp.float64))
    rng = np.random.default_rng(2)
    for p in params:
        p["w2"] = 0.3 * rng.standard_normal(p["w2"].shape)
    return params


def test_toy2d_flow_loss_gradient_and_adam_steps():
    n = 16
    params = _jax_coupling()

    def jloss(p, key):
        return zs.variational.elbo(
            jtf.log_joint, {},
            variational=jtf.build_flow_variational(p, n, key),
            axis=0).sgvb()

    tparams = tt.params_from_numpy(params, device="cpu")
    key = jax.random.PRNGKey(4)
    want, want_g = jax.value_and_grad(jloss)(params, key)
    eps = _node_normals(key, "z", (n, 2))
    got = ttf.loss_fn(tparams, n, 0, noise={"z": eps})
    got.backward()
    _close(got, want)
    for gp, wp in zip(tparams, want_g):
        for k in wp:
            _close(gp[k].grad, wp[k])
    # Three chained Adam(5e-3) steps of the example's train step.
    tparams = tt.params_from_numpy(params, device="cpu")
    step = ttf.make_train_step(torch.optim.Adam(
        [v for p in tparams for v in p.values()], lr=5e-3), n)
    opt = optax.adam(5e-3)
    jp, js = params, opt.init(params)
    for i in range(3):
        k = jax.random.PRNGKey(10 + i)
        val, g = jax.value_and_grad(jloss)(jp, k)
        upd, js = opt.update(g, js)
        jp = optax.apply_updates(jp, upd)
        lb = step(tparams, 0, noise={"z": _node_normals(k, "z", (n, 2))})
        _close(lb, -val, TOL_CHAIN)
    for gp, wp in zip(tparams, jp):
        for k in wp:
            _close(gp[k], wp[k], TOL_CHAIN)


def test_toy2d_flow_log_joint_and_run():
    z = np.random.default_rng(3).standard_normal((5, 2))
    _close(ttf.log_joint({"z": torch.tensor(z)}), jtf.log_joint({"z": z}),
           1e-12)
    flow_lb, params, bounds = ttf.run("cpu", n_iters=3, n_particles=8,
                                      n_flows=2, hidden=4, verbose=False)
    assert math.isfinite(flow_lb) and bounds.shape == (3,)


# --------------------------------------------------------------------- #
# normalizing_flows/vae_nf.py
# --------------------------------------------------------------------- #
def test_vae_nf_loss_and_gradient():
    key = jax.random.PRNGKey(5)
    params = _f64(jvae.init_params(key, 64, 8, hidden=32))
    params["flow"] = _f64(jt.init_planar_flow(key, 4, 8))
    for p in params["flow"]:  # wider than the 0.005 init, so flows bend
        p["u"] = 200.0 * p["u"]
        p["w"] = 200.0 * p["w"]
    x = (np.random.default_rng(6).uniform(size=(16, 64)) < 0.5).astype(
        np.float64)
    want, want_g = jax.value_and_grad(jnf.nf_elbo_loss)(params, x, key, 8)
    tparams = tnn.params_from_numpy(params, device="cpu")
    got = tnf.nf_elbo_loss(tparams, torch.tensor(x), 0, 8,
                           noise={"z": _node_normals(key, "z", (1, 16, 8))})
    got.backward()
    _close(got, want)
    jax.tree.map(lambda w, t: _close(t.grad, w), want_g, tparams)


def test_vae_nf_init_and_epoch():
    params = tnf.init_params(torch.Generator().manual_seed(0), 64, 8, 4,
                             hidden=16)
    assert len(params["flow"]) == 4 and params["flow"][0]["u"].requires_grad
    step = tnf.make_train_step(torch.optim.Adam(tree_leaves(params),
                                                lr=1e-3), 8)
    x = (torch.rand(64, 64, generator=torch.Generator().manual_seed(1))
         < 0.5).float()
    lbs = tnf.run_epoch(step, params, x, 1, torch.Generator().manual_seed(2),
                        batch_size=16)
    assert lbs.shape == (4,) and bool(torch.isfinite(lbs).all())


# --------------------------------------------------------------------- #
# stein_variational/blr_svgd.py
# --------------------------------------------------------------------- #
def test_blr_svgd_cut_main():
    n_particles, n_iters = 10, 30
    want_acc, want_base = jbl.main(n_particles=n_particles, n_iters=n_iters)
    x_train, y_train, x_test, y_test, synthetic = tbl.load_data()
    jx, jy, jxt, jyt, jsyn = jdataset.load_uci_german_credits()
    assert synthetic == jsyn
    np.testing.assert_array_equal(y_test, jyt)
    d = x_train.shape[1]
    w0 = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(0),
                                            (n_particles, d)))
    acc, base, state, diag = tbl.run("cpu", n_particles, n_iters,
                                     dtype=torch.float64, w0=w0,
                                     verbose=False)
    # (JAX's mean of a bool array is float32.)
    assert abs(acc - want_acc) < 1e-6 and base == want_base
    # The particles against the JAX file's log-joint under JAX's SVGD.
    j = zs.variational.SVGD(learning_rate=0.05)
    js, jdiag = j.run(jbl.make_log_joint(x_train, y_train), {},
                      j.init({"w": w0}), n_iters, collect=True)
    _close(state.particles["w"], js.particles["w"], TOL_CHAIN)
    _close(diag["bandwidth"], jdiag["bandwidth"], TOL_CHAIN)
    _close(tbl.predict_proba(state.particles["w"], torch.tensor(x_test)),
           jbl.predict_proba(js.particles["w"], x_test), TOL_CHAIN)


def test_load_uci_german_credits_fallback():
    got = tdataset.load_uci_german_credits()
    want = jdataset.load_uci_german_credits()
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


# --------------------------------------------------------------------- #
# toy_examples/neal_funnel_neutra.py
# --------------------------------------------------------------------- #
def _hmc_noise(key, shape):
    """JAX ``HMC.sample(key)``'s draws: ``split(key, 3) -> key_p, key_u,
    key_j``, the normals from ``split(key_p, 1)[0]``."""
    key_p, key_u, _ = jax.random.split(key, 3)
    (kp,) = jax.random.split(key_p, 1)
    return (torch.tensor(np.asarray(jax.random.normal(kp, shape,
                                                      jnp.float64))),
            torch.tensor(np.asarray(jax.random.uniform(key_u, shape[:1],
                                                       jnp.float64))))


def test_neal_funnel_fit_lifted_density_and_hmc_steps():
    z = np.random.default_rng(8).standard_normal((6, tfun.D))
    _close(tfun.log_joint({"z": torch.tensor(z)}), jfun.log_joint({"z": z}),
           1e-12)
    # 20 fit steps from JAX's flow on JAX's draws.
    key = jax.random.PRNGKey(3)
    n_iters, n_particles = 20, 8
    jfit = zs.mcmc.fit_neutra(jfun.log_joint, "z", jfun.D, key, n_flows=3,
                              n_iters=n_iters, n_particles=n_particles,
                              learning_rate=2e-3, dtype=jnp.float64)
    k_init, k_fit = jax.random.split(key)
    init = jt.init_affine_coupling(k_init, 3, jfun.D, hidden=32,
                                   dtype=jnp.float64)
    noise = np.stack([np.asarray(jax.random.normal(
        k, (n_particles, jfun.D), jnp.float64))
        for k in jax.random.split(k_fit, n_iters)])
    tfit = fit_neutra(tfun.log_joint, "z", tfun.D, n_flows=3,
                      n_iters=n_iters, n_particles=n_particles,
                      learning_rate=2e-3,
                      init_params=tt.params_from_numpy(_f64(init),
                                                       device="cpu"),
                      noise=noise)
    _close(tfit.losses, jfit.losses, TOL_CHAIN)
    # Three HMC iterations of the example's sampler on the lifted density.
    jlat, _, jfrom = zs.mcmc.neutra_log_joint(jfun.log_joint, "z",
                                              jfit.params)
    tlat, _, tfrom = neutra_log_joint(tfun.log_joint, "z", tfit.params)
    jhmc = zs.HMC(step_size=0.1, n_leapfrogs=8, adapt_step_size=True,
                  adapt_mass=True, target_acceptance_rate=0.8)
    n_chains = 6
    q0 = 0.5 * np.random.default_rng(9).standard_normal((n_chains, jfun.D))
    jst = jhmc.init({"z": jnp.asarray(q0)}, n_chain_dims=1)
    thmc = tfun.make_hmc()
    tst = thmc_mod.state_from_numpy(jax.tree.map(np.asarray, jst),
                                    device="cpu")
    for i in range(3):
        k = jax.random.PRNGKey(20 + i)
        jst, jinfo = jhmc.sample(jlat, {}, jst, k, adapt_step_size=False,
                                 adapt_mass=False)
        tst, tinfo = thmc.sample(tlat, {}, tst, adapt_step_size=False,
                                 adapt_mass=False,
                                 noise=_hmc_noise(k, (n_chains, jfun.D)))
        _close(tst.q["z"], jst.q["z"], TOL_CHAIN)
    _close(tfrom(tst.q["z"]), jfrom(jst.q["z"]), TOL_CHAIN)


def test_neal_funnel_run_smoke():
    std_plain, std_neutra, fit = tfun.run(
        "cpu", n_flows=2, n_fit_iters=4, n_chains=8, n_iters=6, n_adapt=3,
        verbose=False)
    assert math.isfinite(std_plain) and math.isfinite(std_neutra)
    assert fit.losses.shape == (4,)


# --------------------------------------------------------------------- #
# toy_examples/gaussian_chees.py
# --------------------------------------------------------------------- #
def _chees_noise(key, shape):
    """JAX ChEES's plain-path draws: ``split(key) -> key_p, key_u``
    (unit mass), in float32 as the example's model is."""
    key_p, key_u = jax.random.split(key)
    p = jbase.tree_random_momentum(
        key_p, {"x": jnp.zeros(shape, jnp.float32)},
        {"x": jnp.ones((1,) + shape[1:], jnp.float32)})["x"]
    u = jax.random.uniform(key_u, shape[:1], jnp.float32)
    return torch.tensor(np.asarray(p)), torch.tensor(np.asarray(u))


def test_gaussian_chees_cut_main(monkeypatch):
    n_chains, n_iters, n_adapt = 8, 14, 7
    monkeypatch.setattr(sys, "argv", [
        "gaussian_chees", "--n_chains", str(n_chains), "--n_iters",
        str(n_iters), "--n_adapt", str(n_adapt)])
    want = jgch.main()
    # The port's model route, iteration by iteration on JAX's draws.
    chees = tgch.make_chees(False)
    model = tgch.log_joint(False, n_chains, torch.float32, "cpu")
    st = chees.init({"x": torch.zeros(n_chains, tgch.N_X)})
    k = jax.random.PRNGKey(0)
    rows = []
    for i in range(n_iters):
        k, sub = jax.random.split(k)
        st, info = chees.sample(model, {}, st, adapt=i < n_adapt,
                                noise=_chees_noise(sub, (n_chains,
                                                         tgch.N_X)))
        rows.append(info.samples["x"])
    keep = torch.stack(rows[n_adapt:]).reshape(-1, tgch.N_X).double()
    rel_err = float((keep.std(0, unbiased=False)
                     / tgch.stdev(torch.float64) - 1.0).abs().max())
    assert abs(rel_err - want) < 1e-4 * (1 + abs(want))


def test_gaussian_chees_fused_route_on_the_cpu():
    # On CPU tensors --fused runs the plain path: the same chain as the
    # model route (the built-in density differs from the model's by a
    # constant), K7's launch count untouched.
    before = fused_chees_step.launches
    _, out_f, rel_f = tgch.run("cpu", True, n_chains=16, n_iters=20,
                               n_adapt=10, dtype=torch.float64)
    _, out_m, rel_m = tgch.run("cpu", False, n_chains=16, n_iters=20,
                               n_adapt=10, dtype=torch.float64)
    assert fused_chees_step.launches == before
    _close(out_f["samples"]["x"], out_m["samples"]["x"], TOL_CHAIN)
    _close(rel_f, rel_m, TOL_CHAIN)
    assert out_f["n_leapfrogs"].tolist() == out_m["n_leapfrogs"].tolist()


def test_gaussian_chees_k7_plain_version_at_512x16():
    # K7's CPU wrapper is its plain version, which holds the sampler's
    # transition at the example's width.
    c, d = tgch.N_CHAINS, tgch.N_X
    g = torch.Generator().manual_seed(0)
    dens = tgch.log_joint(True)
    q = tgch.stdev() * torch.randn(c, d, generator=g)
    mass = torch.ones(1, d)
    noise = (torch.randn(c, d, generator=g), torch.rand(c, generator=g))
    n = torch.tensor(7, dtype=torch.int32)
    before = fused_chees_step.launches
    got = fused_chees_step(dens, q, mass, 0.2, n, (1, 2), 1, noise=noise)
    assert fused_chees_step.launches == before
    want = fused_chees_step_reference(dens, q, mass, 0.2, n, (1, 2), 1,
                                      noise=noise)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.cuda
def test_gaussian_chees_k7_on_card_at_512x16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    c, d = tgch.N_CHAINS, tgch.N_X
    g = torch.Generator(device=dev).manual_seed(0)
    dens = tgch.log_joint(True, device=dev)
    q = tgch.stdev(device=dev) * torch.randn(c, d, generator=g, device=dev)
    mass = torch.ones(1, d, device=dev)
    noise = (torch.randn(c, d, generator=g, device=dev),
             torch.rand(c, generator=g, device=dev))
    n = torch.tensor(7, dtype=torch.int32, device=dev)
    before = fused_chees_step.launches
    got = fused_chees_step(dens, q, mass, 0.2, n, (1, 2), 1, noise=noise)
    torch.cuda.synchronize()
    assert fused_chees_step.launches == before + 1
    want = fused_chees_step_reference(dens, q, mass, 0.2, n, (1, 2), 1,
                                      noise=noise)
    u = noise[1]
    assert int(((u < got[3]) != (u < want[3])).sum()) == 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# toy_examples/mixture_sgnht.py
# --------------------------------------------------------------------- #
def test_mixture_sgnht_cut_main():
    n_chains, n_iters = 12, 300
    want = jms.main(n_chains=n_chains, n_iters=n_iters)  # thinned: 1 row
    key = jax.random.PRNGKey(1)
    k_init, k_x, k_run = jax.random.split(key, 3)
    x0 = np.asarray(jax.random.uniform(k_x, (n_chains,))) * 10 - 5
    like = {"x": jnp.asarray(x0)}
    sg = tms.make_sgnht()
    st = sg.init({"x": torch.tensor(x0)},
                 noise={"x": torch.tensor(np.asarray(
                     jbase.tree_normal_like(k_init, like)["x"]))})
    burnin = n_iters * 2 // 3

    def steps(st, key, n):
        k = key
        for _ in range(n):
            k, sub = jax.random.split(k)
            _, key_n = jax.random.split(sub)
            eps = np.asarray(jbase.tree_normal_like(key_n, like)["x"])
            st, _ = sg.sample(tms.log_joint, {}, st,
                              noise=(torch.tensor(eps), None))
        return st

    st = steps(st, k_run, burnin)
    st = steps(st, jax.random.PRNGKey(2), n_iters - burnin)
    _close(st.q["x"], np.asarray(want).reshape(-1), TOL_CHAIN)
    # The JAX file keeps its log-joint inside main: the mixture itself.
    x = np.random.default_rng(10).uniform(-4, 6, size=7)
    _close(tms.log_joint({"x": torch.tensor(x)}),
           np.logaddexp(-0.5 * ((x + 1.0) / 0.5) ** 2,
                        -0.5 * ((x - 3.0) / 0.5) ** 2), 1e-12)


def test_mixture_sgnht_run_smoke():
    samples, state = tms.run("cpu", n_chains=10, n_iters=300)
    assert samples.shape == (1, 10) and state.t == 300
    assert bool(torch.isfinite(samples).all())
