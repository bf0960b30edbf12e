"""The job loop's arithmetic and the trace's, on synthetic numbers."""

import json
import math

import pytest

from benchmark import harness, tracing

CELL = {"chains": 10, "n_warmup": 3, "n_sample": 7}


def _jobs(times, ess=5.0, failed=()):
    return [{"seconds": t, "ess": 0.0 if i in failed else ess,
             "failed": i in failed} for i, t in enumerate(times)]


def test_window_metrics_sum_over_the_window():
    jobs = _jobs([0.1 * (i + 1) for i in range(20)])
    m = harness.window_metrics(jobs, 25.0, CELL)
    assert m["ess_per_s"] == pytest.approx(20 * 5.0 / 25.0)
    assert m["draws_per_s"] == pytest.approx(20 * 10 * 10 / 25.0)
    # nearest rank: the 18th of 20 sorted times
    assert m["job_p90_s"] == pytest.approx(1.8)


def test_a_failed_job_is_over_any_limit():
    jobs = _jobs([0.1] * 9 + [0.2], failed=(3,))
    m = harness.window_metrics(jobs, 2.0, CELL)
    assert m["job_p90_s"] == pytest.approx(0.2)
    jobs = _jobs([0.1] * 9, failed=(1, 2))
    assert math.isinf(harness.window_metrics(jobs, 2.0, CELL)["job_p90_s"])
    assert harness.window_metrics(jobs, 2.0, CELL)["draws_per_s"] == (
        pytest.approx(7 * 100 / 2.0))


@pytest.mark.parametrize("n, q, want", [(100, 0.9, 90), (101, 0.9, 91),
                                        (10, 0.9, 9), (1, 0.9, 1)])
def test_percentile_nearest_rank(n, q, want):
    assert harness.percentile(list(range(n, 0, -1)), q) == want


def test_job_keys_differ_and_repeat():
    seed = 2 ** 33 + 5
    assert harness.job_key(seed, 0) == harness.job_key(seed, 0)
    assert harness.job_key(seed, 0) != harness.job_key(seed, 1)
    assert harness.job_key(seed, 0) != harness.job_key(seed + 1, 0)
    assert all(0 <= k < 2 ** 32 for k in harness.job_key(seed, 7))


def test_checked_job_is_drawn_from_the_seed_among_all_jobs():
    """The same seed keeps the same job; over seeds every job of the
    window is kept about equally often, the last ones too."""
    def kept(seed, n):
        r = harness.Reservoir(seed)
        for i in range(n):
            r.offer(i, {"job": i})
        return r.kept

    assert kept(2 ** 40 + 3, 50) == kept(2 ** 40 + 3, 50)
    counts = [0] * 10
    for seed in range(2000):
        counts[kept(2 ** 33 + seed, 10)[0]] += 1
    assert min(counts) > 140 and max(counts) < 260, counts


def test_judge_needs_every_number_under_its_limit():
    ok, shown = harness.judge({"a": 0.1, "b": 2.0}, {"a": 1.0, "b": 1.0})
    assert not ok and shown["b"] == {"value": 2.0, "limit": 1.0}
    assert harness.judge({"a": 0.1}, {"a": 1.0})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.judge({}, {"a": 1.0})[0]


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_busy_ops_and_gaps(tmp_path):
    ev = [_event("user_annotation", "bench.job", 0, 1000),
          _event("user_annotation", "bench.sample", 100, 500),
          _event("cpu_op", "aten::mul", 140, 20),
          _event("cuda_runtime", "cudaLaunchKernel", 150, 5, 1),
          _event("kernel", "k_a", 200, 100, 1),
          _event("kernel", "k_b", 250, 100, 2),
          _event("gpu_memcpy", "copy", 500, 50, 3)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = tracing.Trace(str(path))
    assert t.busy() == pytest.approx(200e-6)
    assert len(t.in_stage("bench.sample")) == 3
    assert [n for n, _ in t.kernels("k_")] == ["k_a", "k_b"]
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("k_a", "k_b")
    gaps = dict(b["idle_gaps"])
    assert gaps["bench.sample / aten::mul"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(800e-6)
