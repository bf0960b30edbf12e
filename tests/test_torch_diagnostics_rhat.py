"""Parity tests of the port's R-hat family, ``summary`` and the kernelized
Stein discrepancy (``zhusuan_tpu_torch/diagnostics.py``) against the JAX
package's numpy versions (``zhusuan_tpu/diagnostics.py``), in float64 on
the CPU, on autocorrelated AR(1) chains (near-iid chains hide estimator
differences, ROADMAP "ESS parity inputs")."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu.diagnostics as jd
import zhusuan_tpu_torch.diagnostics as td

torch.set_num_threads(1)

TOL = 1e-12


def _ar1(seed, n, m, shape=(), rho=0.7, scales=None):
    """``[n, m] + shape`` AR(1) chains, chain-specific offsets and scales
    so that R-hat is not trivially 1."""
    rs = np.random.RandomState(seed)
    x = np.empty((n, m) + shape)
    x[0] = rs.randn(m, *shape)
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho ** 2) * rs.randn(m, *shape)
    off = 0.3 * rs.randn(m, *shape)
    sc = rs.uniform(0.5, 1.5, (m,) + shape) if scales is None else scales
    return x * sc + off


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
@pytest.mark.parametrize("n", [40, 41])
def test_split_and_rank_normalized_rhat_match_jax(shape, n):
    x = _ar1(0, n, 6, shape)
    for rank in (False, True):
        got = td.potential_scale_reduction(torch.as_tensor(x), rank)
        want = jd.potential_scale_reduction(x, rank)
        assert tuple(got.shape) == np.shape(want)
        assert got.dtype == torch.float64
        _close(got, want)


@pytest.mark.parametrize("n", [1, 2, 30])
@pytest.mark.parametrize("rank", [False, True])
def test_nested_rhat_matches_jax(n, rank):
    x = _ar1(1, n, 12, (4,))
    for k in (2, 3, 4):
        _close(td.nested_rhat(x, k, rank_normalized=rank),
               jd.nested_rhat(x, k, rank_normalized=rank))


def test_rank_normalize_with_ties_and_constant_columns_matches_jax():
    rs = np.random.RandomState(2)
    x = np.stack([rs.randint(0, 3, (20, 4)).astype(np.float64),  # ties
                  np.full((20, 4), 1.5),                         # constant
                  rs.randn(20, 4)], axis=-1)
    _close(td._rank_normalize(torch.as_tensor(x)), jd._rank_normalize(x))
    # Constant and discrete latents: average ranks keep R-hat at 1-ish
    # (ordinal ranks would make it ~1.5 on the constant column).
    got = td.potential_scale_reduction(x, rank_normalized=True)
    want = jd.potential_scale_reduction(x, rank_normalized=True)
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL,
                               equal_nan=True)
    assert np.isnan(_np(got)[1])  # 0/0 on the constant column, as JAX


def test_folded_rhat_uses_numpys_even_count_median():
    # 4 x 2 draws: an even count whose two middle values differ, so the
    # lower-middle median would move every folded score.
    x = np.array([[[0.0], [5.0]], [[1.0], [7.0]], [[2.0], [9.0]],
                  [[3.0], [4.0]]])
    assert np.median(x, axis=(0, 1))[0] == 3.5
    sv, _ = td._sorted_columns(torch.as_tensor(x.reshape(8, 1)))
    assert float(td._median_of_sorted(sv)[0]) == 3.5
    for rank in (True,):
        _close(td.potential_scale_reduction(x, rank),
               jd.potential_scale_reduction(x, rank))
        _close(td.nested_rhat(x, 2, rank), jd.nested_rhat(x, 2, rank))


def test_chunked_columns_give_the_unchunked_answer(monkeypatch):
    x = torch.as_tensor(_ar1(3, 30, 5, (7,)))
    whole = td.potential_scale_reduction(x, True)
    stats, table = td.summary({"z": x}, rank_normalized=True)
    monkeypatch.setattr(td, "CHUNK_ELEMENTS", 150)  # one column a chunk
    # Only the reductions' order may differ between chunkings.
    _close(td.potential_scale_reduction(x, True), _np(whole), 1e-14)
    stats2, table2 = td.summary({"z": x}, rank_normalized=True)
    assert table2 == table
    for f in stats["z"]:
        _close(stats2["z"][f], _np(stats["z"][f]), 1e-14)


def _check_summary(samples, **kw):
    tstats, ttable = td.summary(
        {k: torch.as_tensor(v) for k, v in samples.items()}
        if isinstance(samples, dict) else torch.as_tensor(samples), **kw)
    jstats, jtable = jd.summary(samples, **kw)
    assert ttable == jtable
    assert list(tstats) == list(jstats)
    for name in jstats:
        for f in ("mean", "sd", "r_hat", "ess"):
            got = tstats[name][f]
            assert got.device.type == "cpu" and got.dtype == torch.float64
            assert tuple(got.shape) == np.shape(jstats[name][f])
            np.testing.assert_allclose(_np(got), jstats[name][f],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rank", [False, True])
def test_summary_matches_jax_stats_and_table(rank):
    samples = {"w": _ar1(4, 60, 4, (3,)), "b": _ar1(5, 60, 4, ()),
               "m": _ar1(6, 60, 4, (2, 2))}
    _check_summary(samples, rank_normalized=rank)
    _check_summary(samples, rank_normalized=rank, round_to=5,
                   n_superchains=2)
    _check_summary(samples["w"])


def test_summary_frozen_chain_and_single_draw_cases():
    x = _ar1(7, 50, 5, (3,))
    x[:, 2, :] = 0.25  # a chain that never moved
    x[:, :, 1] = 1.0  # a column constant everywhere
    _check_summary({"x": x})
    stats, _ = td.summary({"x": torch.as_tensor(x)})
    full, _ = td.summary({"x": torch.as_tensor(_ar1(7, 50, 5, (3,)))})
    assert float(stats["x"]["ess"][0]) < float(full["x"]["ess"][0])
    assert float(stats["x"]["ess"][1]) == 0.0
    # n_iters == 1: one independent draw a chain; nested R-hat needed.
    one = _ar1(8, 1, 8, (2,))
    _check_summary({"x": one}, n_superchains=4)
    stats, _ = td.summary({"x": torch.as_tensor(one)}, n_superchains=4)
    assert stats["x"]["ess"].tolist() == [8.0, 8.0]
    with pytest.raises(ValueError, match="n_iters >= 2"):
        td.summary({"x": torch.as_tensor(one)})
    with pytest.raises(ValueError, match="n_iters >= 2"):
        jd.summary({"x": one})


def test_argument_errors_match_jax():
    x = _ar1(9, 10, 6)
    for bad_k in (1, 4):
        with pytest.raises(ValueError) as t_err:
            td.nested_rhat(x, bad_k)
        with pytest.raises(ValueError) as j_err:
            jd.nested_rhat(x, bad_k)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as t_err:
        td.potential_scale_reduction(x[:1])
    with pytest.raises(ValueError) as j_err:
        jd.potential_scale_reduction(x[:1])
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="summary expects"):
        td.summary({"v": torch.zeros(5)})


def _gauss_score_t(x):
    return -x / torch.as_tensor([0.5, 1.0, 2.0], dtype=x.dtype) ** 2


def _gauss_score_j(x):
    return -x / jnp.asarray([0.5, 1.0, 2.0], x.dtype) ** 2


@pytest.mark.parametrize("c,beta", [(1.0, -0.5), (0.7, -0.3)])
def test_kernel_stein_discrepancy_matches_jax(c, beta):
    rs = np.random.RandomState(10)
    x = rs.randn(200, 3) * np.array([0.5, 1.0, 2.0])
    for shift in (0.0, 0.5):
        got = td.kernel_stein_discrepancy(torch.as_tensor(x + shift),
                                          _gauss_score_t, c, beta)
        want = jd.kernel_stein_discrepancy(jnp.asarray(x + shift),
                                           _gauss_score_j, c, beta)
        assert got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-10,
                                   atol=1e-10)
    near = td.kernel_stein_discrepancy(torch.as_tensor(x), _gauss_score_t)
    far = td.kernel_stein_discrepancy(torch.as_tensor(x + 0.5),
                                      _gauss_score_t)
    assert float(far) > 10 * abs(float(near))
    with pytest.raises(ValueError):
        td.kernel_stein_discrepancy(torch.zeros(1, 3), _gauss_score_t)
    with pytest.raises(ValueError):
        td.kernel_stein_discrepancy(torch.zeros(3), _gauss_score_t)


def test_bfloat16_draws_are_read_in_float64():
    x = torch.as_tensor(_ar1(11, 40, 8, (5,))).to(torch.bfloat16)
    want = jd.potential_scale_reduction(x.double().numpy(), True)
    _close(td.potential_scale_reduction(x, True), want)
    stats, table = td.summary({"x": x})
    jstats, jtable = jd.summary({"x": x.double().numpy()})
    assert table == jtable

