"""The port's SMC and state-space examples on the CPU, at the JAX tests'
reduced sizes and gates (``tests/test_examples.py:784-795`` and
``:924-949``): ``bayes_factor_smc.main(n_particles=1500)`` within 0.3 of
both closed-form evidences; the stochastic-volatility filter at T = 100
with 256 particles tracking ``h`` (RMSE < 0.9) and PMMH at 128 particles,
4 chains x 400 iterations (100 burn-in) recovering ``(mu, phi, sigma)``
within the JAX test's bounds. The draws are the port's own (``torch``
generators): the gates, not the JAX numbers, are what carries over."""

import numpy as np
import torch

from zhusuan_tpu_torch.examples.model_comparison import bayes_factor_smc as bf
from zhusuan_tpu_torch.examples.state_space import stochastic_volatility as sv


def test_bayes_factor_smc_matches_closed_form():
    results = bf.main(n_particles=1500, device="cpu")
    assert set(results) == {1, 2}
    for degree, (est, truth) in results.items():
        assert abs(est - truth) < 0.3, (degree, est, truth)


def test_stochastic_volatility_filter_and_pmmh():
    hs_true, ys, synthetic = sv.simulate(100)
    assert synthetic
    ys_t = torch.tensor(ys, dtype=torch.float64)
    theta_true = {k: torch.tensor(v, dtype=torch.float64)
                  for k, v in (("mu", sv.TRUE["mu"]),
                               ("phi_u", np.arctanh(sv.TRUE["phi"])),
                               ("log_sigma", np.log(sv.TRUE["sigma"])))}
    res = sv.make_filter(theta_true, ys_t, 256).run((1, 0), ys_t)
    rmse = float(torch.sqrt(torch.mean(
        (res.filter_means - torch.tensor(hs_true)) ** 2)))
    assert np.isfinite(float(res.log_z))
    assert rmse < 0.9

    _, out = sv.run_pmmh(ys_t, n_particles=128, n_chains=4, n_iters=400,
                         seed=0)
    draws = {k: v[100:].numpy() for k, v in out["samples"].items()}
    acc = float(out["acceptance_rate"].mean())
    assert 0.1 < acc < 0.95
    assert -2.2 < draws["mu"].mean() < 0.2
    assert 0.85 < np.tanh(draws["phi_u"]).mean() < 0.995
    assert 0.12 < np.exp(draws["log_sigma"]).mean() < 0.45


def test_stochastic_volatility_main_cli():
    res = sv.main(["--t", "40", "--n-particles", "32", "--n-chains", "2",
                   "--n-iters", "6", "--burnin", "2", "--device", "cpu"])
    assert set(res) == {"mu", "phi", "sigma", "acc", "rmse"}
    assert all(np.isfinite(v) for v in res.values())


def test_chip_smoke_names_are_assigned_once():
    """``chip_smoke.py``'s phases share one module namespace: a constant
    assigned twice silently changes an earlier phase's recipe (phase 34
    once reused phase 32's ``PF_PATHS``)."""
    import ast
    import collections
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name))
        elif isinstance(node, ast.FunctionDef):
            names[node.name] += 1
    assert [k for k, v in names.items() if v > 1] == []
