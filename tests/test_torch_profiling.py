"""The port's profiling helpers (``zhusuan_tpu_torch/profiling.py``)
against ``zhusuan_tpu/profiling.py``: ``ess_per_sec`` on the same draws at
1e-10 (float64), the meter, and a CPU trace that names its scope.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

import zhusuan_tpu_torch as zt
from zhusuan_tpu.profiling import ess_per_sec as jax_ess_per_sec
from zhusuan_tpu_torch.profiling import (
    SpeedMeter,
    ess_per_sec,
    named_scope,
    trace,
)


def _ar1(shape, rho, seed):
    """An AR(1) trajectory along axis 0 (autocorrelated: its ESS depends
    on the data, unlike near-iid input's fixed point)."""
    rng = np.random.RandomState(seed)
    x = np.empty(shape)
    x[0] = rng.randn(*shape[1:])
    for i in range(1, shape[0]):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho ** 2) * rng.randn(*shape[1:])
    return x


def _jax_ess_per_sec_f64(samples, wall_seconds):
    """The JAX package's ``ess_per_sec`` with its estimator evaluated in
    float64 (``diagnostics.ess_batch``, the same estimator as the float32
    FFT of ``ess_batch_device`` that ``ess_per_sec`` calls)."""
    from zhusuan_tpu.diagnostics import ess_batch

    if samples.ndim == 2:
        samples = samples[:, None, :]
    t, c, d = samples.shape
    ess = ess_batch(samples.reshape(t, c * d)).reshape(c, d)
    return float(np.minimum.reduce(ess, axis=1).sum() / wall_seconds)


@pytest.mark.parametrize("draws", ["iid", "ar1", "two_d"])
def test_ess_per_sec_matches_jax(draws):
    """At 1e-10 against the JAX package's estimator in float64; against its
    ``ess_per_sec`` itself at 1e-5, since that one runs its FFT in
    float32 whatever the input's dtype."""
    if draws == "iid":  # tests/test_checkpoint.py:56-61
        samples = np.random.RandomState(0).randn(200, 3, 4)
    elif draws == "ar1":
        samples = _ar1((200, 3, 4), 0.8, 1)
    else:
        samples = _ar1((300, 5), 0.6, 2)
    got = ess_per_sec(torch.as_tensor(samples), wall_seconds=2.0)
    assert got > 0
    np.testing.assert_allclose(got, _jax_ess_per_sec_f64(samples, 2.0),
                               rtol=1e-10)
    np.testing.assert_allclose(got, jax_ess_per_sec(samples, 2.0),
                               rtol=1e-5)
    # numpy input is accepted as in the JAX package.
    np.testing.assert_allclose(ess_per_sec(samples, 2.0), got, rtol=0)


def test_speed_meter():
    m = SpeedMeter(items_per_step=32)
    for _ in range(5):
        m.tick()
    assert m.steps_per_sec > 0
    assert abs(m.items_per_sec / (32 * m.steps_per_sec) - 1.0) < 0.5
    m.tick(3)
    assert m._steps == 8
    m.reset()
    assert m._steps == 0
    assert "steps/s" in repr(m)


def test_speed_meter_rate():
    m = SpeedMeter(items_per_step=2)
    m.tick(10)
    time.sleep(0.05)
    assert m.steps_per_sec < 10 / 0.05 * 1.01


def test_trace_names_scope(tmp_path):
    """A CPU trace lands in ``log_dir`` as Chrome-trace JSON and names the
    annotated scope and the ops under it."""
    x = torch.randn(64, 64)
    with trace(str(tmp_path)) as prof:
        with named_scope("zs_probe_scope"):
            y = torch.tanh(x @ x)
    assert y.shape == (64, 64)
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "zs_probe_scope" in names
    assert any(n and "tanh" in n for n in names)
    assert any(a.key == "zs_probe_scope" for a in prof.key_averages())


def test_named_scope_is_record_function():
    assert named_scope is torch.profiler.record_function
    assert zt.profiling.trace is trace
