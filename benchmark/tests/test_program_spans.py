"""The readers of the program's ``zs.*`` spans on a small hand-written
chrome trace: self times of nested spans, the stage a span falls in, the
count of host reads, and nothing read from a trace without such spans."""

import json
import types

import pytest

from benchmark import program_spans
from benchmark.metrics import (
    adapt_ms_per_iter,
    host_syncs_per_job,
    loop_self_us_per_iter,
    transition_host_us,
)

READERS = (adapt_ms_per_iter, transition_host_us, loop_self_us_per_iter,
           host_syncs_per_job)


def _note(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 7, "tid": tid}


def _kernel(ts, dur, corr):
    return [{"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
             "pid": 0, "tid": 9, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": ts - 5, "dur": 2, "pid": 7, "tid": 1,
             "args": {"correlation": corr}}]


def _iteration(t0, adapt):
    """One iteration at ``t0`` (microseconds): ``zs.iter`` of 100 holding
    a transition of 30 (a launch of 10 in it) and, when ``adapt``, a
    step-size update of 8 and a mass update of 4."""
    out = [_note("zs.iter", t0, 100), _note("zs.transition", t0 + 10, 30),
           _note("zs.launch", t0 + 20, 10)]
    if adapt:
        out += [_note("zs.adapt.step_size", t0 + 50, 8),
                _note("zs.adapt.mass", t0 + 2, 4)]
    return out


def _trace(with_program=True):
    """A job: a warm-up of 2 adapting iterations (the first with a search
    of two host reads), a sampling stage of 2, and a collect after each
    sampling iteration; one kernel an iteration, launched inside its
    ``zs.launch``."""
    events = [_note("bench.job", 0, 2000), _note("bench.warmup", 0, 600),
              _note("bench.sample", 700, 600), _note("bench.ess", 1400, 100)]
    if with_program:
        events += _iteration(100, True) + _iteration(300, True)
        events += [_note("zs.init_search", 170, 20),
                   _note("zs.sync.init_search", 172, 5),
                   _note("zs.sync.init_search", 180, 6)]
        events += _iteration(800, False) + _iteration(1000, False)
        events += [_note("zs.collect", 900, 12), _note("zs.collect", 1100, 12)]
    for i, t in enumerate((130, 330, 830, 1030)):
        events += _kernel(t, 10, i)
    return {"traceEvents": events}


def _run(tmp_path, monkeypatch, trace):
    path = tmp_path / "cell.trace.json"
    path.write_text(json.dumps(trace))
    monkeypatch.setattr(program_spans, "trace_path", lambda cell: str(path))
    return types.SimpleNamespace(cell={"name": "cell", "n_warmup": 2,
                                       "n_sample": 2})


def test_self_time_less_the_spans_inside(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _trace())
    found = program_spans.of(run)
    by = {(s["name"], round(s["ts"] * 1e6)): s for s in found.spans}
    # The first warm-up iteration: 100 less the transition (30), the
    # mass (4), the step size (8) and the search (20).
    first = by[("zs.iter", 100)]
    assert first["self"] == pytest.approx(38e-6)
    # The transition less its launch.
    assert by[("zs.transition", 110)]["self"] == pytest.approx(20e-6)
    assert by[("zs.init_search", 170)]["self"] == pytest.approx(9e-6)
    assert by[("zs.launch", 120)]["self"] == pytest.approx(10e-6)
    # The reads' parent is the search, the search's the iteration.
    read = by[("zs.sync.init_search", 172)]
    assert found.spans[read["parent"]]["name"] == "zs.init_search"
    search = by[("zs.init_search", 170)]
    assert found.spans[search["parent"]] is first
    assert first["parent"] is None
    # A collect after its iteration is not inside it.
    assert by[("zs.collect", 900)]["parent"] is None


def test_spans_fall_in_their_stage(tmp_path, monkeypatch):
    found = program_spans.of(_run(tmp_path, monkeypatch, _trace()))
    assert {s["stage"] for s in found.named("zs.adapt.")} == {
        "bench.warmup"}
    assert len(found.named("zs.iter", "bench.warmup")) == 2
    assert len(found.named("zs.iter", "bench.sample")) == 2
    assert found.named("zs.iter", "bench.ess") == []


def test_readers(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _trace())
    # (8 + 4) x 2 us over 2 warm-up iterations.
    assert adapt_ms_per_iter.read(run) == pytest.approx(12e-3)
    assert transition_host_us.read(run) == pytest.approx(30.0)
    # A sampling iteration: 100 less its transition.
    assert loop_self_us_per_iter.read(run) == pytest.approx(70.0)
    assert host_syncs_per_job.read(run) == 2.0


def test_trace_read_once_a_run(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _trace())
    found = program_spans.of(run)
    (tmp_path / "cell.trace.json").unlink()
    assert program_spans.of(run) is found
    assert host_syncs_per_job.read(run) == 2.0


def test_no_sync_reads_zero(tmp_path, monkeypatch):
    trace = _trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if not e["name"].startswith("zs.sync.")]
    run = _run(tmp_path, monkeypatch, trace)
    assert host_syncs_per_job.read(run) == 0.0
    assert transition_host_us.read(run) == pytest.approx(30.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.NAME)
def test_nothing_read_without_program_spans(tmp_path, monkeypatch, reader):
    run = _run(tmp_path, monkeypatch, _trace(with_program=False))
    assert reader.read(run) is None


def test_innermost_span_and_idle_gaps(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _trace())
    found = program_spans.of(run)
    assert found.innermost(125e-6)["name"] == "zs.launch"
    assert found.innermost(174e-6)["name"] == "zs.sync.init_search"
    assert found.innermost(178e-6)["name"] == "zs.init_search"
    assert found.innermost(195e-6)["name"] == "zs.iter"
    assert found.innermost(250e-6) is None
    assert found.innermost(50e-6) is None
    path = program_spans.trace_path("cell")
    gaps = program_spans.idle_gaps(path, found)
    # Each kernel's launch (5 us before it) falls in its iteration's
    # zs.launch; the gaps before them: 130, 190, 490, 190 us, and 960
    # after the last.
    assert gaps == pytest.approx({
        "bench.warmup / zs.launch": 320e-6,
        "bench.sample / zs.launch": 680e-6,
        "bench.job / after the last device operation": 960e-6})
