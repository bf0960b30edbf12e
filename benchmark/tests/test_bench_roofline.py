"""The copied counts against counts made by hand at a small shape."""

import pytest

from benchmark.roofline import chees_step, hmc_step, nuts_step, peaks


def test_hmc_step_count_by_hand():
    # 2 chains x 4 dims, 3 leapfrogs: bytes 4 (3*8 + 5*2 + 3*4) = 184;
    # per element 50 + 2 + 6 + 2*5 + 1 + 4 * (5 + 3) = 101 operations.
    w = hmc_step.launch(2, 4, 3)
    assert w["bytes"] == 184 and w["ops"] == 8 * 101
    assert w["bound_by"] == "bytes"
    assert w["seconds"] == pytest.approx(184 / 3.35e12)


def test_chees_step_count_by_hand():
    # K7 writes the proposal too: 4 (4*8 + 3*2 + 4) = 168 bytes.
    w = chees_step.launch(2, 4, 3)
    assert w["bytes"] == 168 and w["ops"] == 8 * 101


def test_nuts_step_count_by_hand():
    # 2 chains x 4 dims, 10 leapfrogs over both chains: 4 (2*8 + 16 + 8)
    # = 160 bytes; 8 * 50 + 10 * 4 * 20 = 1200 operations.
    w = nuts_step.launch(2, 4, 10)
    assert w["bytes"] == 160 and w["ops"] == 1200


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
