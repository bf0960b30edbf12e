"""The copied counts against counts made by hand at a small shape."""

import importlib.util
import os

import pytest

from benchmark.roofline import chees_step, hmc_step, nuts_step, peaks
from benchmark.reference.targets import diagonal_gaussian

# A diagonal Gaussian of 4 dimensions: 5 operations an element a
# log-density, 3 a gradient, and loc and the inverse variance (32 bytes).
GAUSSIAN = diagonal_gaussian.cost({"loc": [0.0] * 4, "std": [1.0] * 4})


def test_gaussian_cost_by_hand():
    assert GAUSSIAN == {"log_prob_ops": 20, "grad_ops": 12, "param_bytes": 32}


def test_hmc_step_count_by_hand():
    # 2 chains x 4 dims, 3 leapfrogs: bytes 4 (3*8 + 5*2 + 3*4) = 184;
    # per element 50 + 2 + 6 + 2*5 + 1 + 4 * (5 + 3) = 101 operations.
    w = hmc_step.launch(2, 4, 3, GAUSSIAN)
    assert w["bytes"] == 184 and w["ops"] == 8 * 101
    assert w["bound_by"] == "bytes"
    assert w["seconds"] == pytest.approx(184 / 3.35e12)


def test_chees_step_count_by_hand():
    # K7 writes the proposal too and reads the mass, loc and the inverse
    # variance: 4 (4*8 + 3*2 + 3*4) = 200 bytes.
    w = chees_step.launch(2, 4, 3, GAUSSIAN)
    assert w["bytes"] == 200 and w["ops"] == 8 * 101


def test_nuts_step_count_by_hand():
    # 2 chains x 4 dims, 10 leapfrogs over both chains: 4 (2*8 + 16 + 3*4)
    # = 176 bytes; 8 * 50 + 10 * 4 * (12 + 3 + 5) = 1200 operations.
    w = nuts_step.launch(2, 4, 10, GAUSSIAN)
    assert w["bytes"] == 176 and w["ops"] == 1200


def _new_target_plain():
    path = os.path.join(os.path.dirname(__file__), "new_target", "reference",
                        "targets", "linear_regression.py")
    spec = importlib.util.spec_from_file_location("linear_regression", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_regression_count_by_hand():
    # The proof target of test_bench_files, 3 rows x 2 predictors: a
    # log-density 2*3*2 + 5*3 + 4*2 = 35 operations, a gradient
    # 4*3*2 + 3*3 + 3*2 = 39, the table 4 (3*3 + 4) = 52 bytes. K1 on 2
    # chains, 3 leapfrogs: 2 (2 (59 + 4*5) + 2*35 + 4*39) = 768
    # operations, 4 (3*4 + 5*2 + 2) + 52 = 148 bytes.
    cost = _new_target_plain().cost({"rows": 3, "dim": 2})
    assert cost == {"log_prob_ops": 35, "grad_ops": 39, "param_bytes": 52}
    w = hmc_step.launch(2, 2, 3, cost)
    assert w["ops"] == 768 and w["bytes"] == 148


def test_least_time_takes_the_larger_bound():
    w = peaks.least_time(3.35e12, 134e12)
    assert w["bound_by"] == "operations" and w["seconds"] == pytest.approx(2.0)
    w = peaks.least_time(6.7e12, 67e12)
    assert w["bound_by"] == "bytes" and w["seconds"] == pytest.approx(2.0)


def test_kernel_patterns_tell_the_modes_apart():
    import re

    k1 = "void hmc_family_kernel<4, float, DiagonalDensity, 0>(Args)"
    k7 = "void hmc_family_kernel<4, float, DiagonalDensity, 1>(Args)"
    assert re.search(hmc_step.PATTERN, k1) and not re.search(
        hmc_step.PATTERN, k7)
    assert re.search(chees_step.PATTERN, k7) and not re.search(
        chees_step.PATTERN, k1)
