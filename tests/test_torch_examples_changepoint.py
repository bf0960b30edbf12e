"""The port's change-point example (``zhusuan_tpu_torch/examples/
state_space/changepoint.py``) against ``examples/state_space/
changepoint.py`` on the CPU: the log joint at 1e-12 on the same counts and
latents (float64), and ``run`` on the JAX example's counts at a cut size
(16 chains, 300 sweeps of which 100 burn in, of the defaults' 64, 2000 and
500): the same ``tau`` mode, and both rates' posterior means within 0.15 of
the JAX run's (the two runs draw different numbers; the rates' Monte-Carlo
error at this size is ~0.02). The synthetic-data path runs too."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from examples.state_space import changepoint as jcp
from zhusuan_tpu_torch.examples.state_space import changepoint as tcp

CUT = {"t": 60, "n_chains": 16, "n_iters": 300, "burnin": 100}
LAM_TOL = 0.15


def test_log_joint_matches_jax():
    y, _ = jcp.make_data(60, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tau = rng.integers(1, 60, (5, 3, 1)).astype(np.float64)
    log_lam = rng.standard_normal((5, 3, 2))
    want = jcp.build_log_joint(jnp.asarray(y, jnp.float64))(
        {"tau": jnp.asarray(tau), "log_lam": jnp.asarray(log_lam)})
    got = tcp.build_log_joint(torch.tensor(np.asarray(y), dtype=torch.float64))(
        {"tau": torch.tensor(tau), "log_lam": torch.tensor(log_lam)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_run_on_the_jax_counts():
    want = jcp.run(**CUT)
    y, _ = jcp.make_data(CUT["t"], jax.random.PRNGKey(0))
    got = tcp.run(**CUT, y=torch.tensor(np.asarray(y), dtype=torch.float64),
                  device="cpu")
    assert got["synthetic"] is False
    assert got["tau_draws"].shape == (
        (CUT["n_iters"] - CUT["burnin"]) * CUT["n_chains"],)
    assert got["tau_mode"] == want["tau_mode"]
    np.testing.assert_allclose(got["lam_mean"], want["lam_mean"],
                               atol=LAM_TOL)


def test_synthetic_run():
    res = tcp.run(n_chains=8, n_iters=150, burnin=50, device="cpu")
    assert res["synthetic"] is True
    assert abs(res["tau_mode"] - tcp.TRUE["tau"]) <= 4
    assert np.isfinite(res["lam_mean"]).all()
    assert res["lam_mean"][0] > res["lam_mean"][1]
