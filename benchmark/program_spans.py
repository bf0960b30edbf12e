"""The program's own spans in the profiled job's trace.

``zhusuan_tpu_torch.profiling.span`` names the layers of the MCMC hot path
in a profiler's trace as ``zs.*`` annotations: the run loop (``zs.iter``,
``zs.collect``), adaptation (``zs.adapt.*``), transitions
(``zs.transition``, ``zs.init_search``, ``zs.chees.jitter``), kernel
launches (``zs.launch``) and host reads of the device (``zs.sync.*``).
This module reads them from ``_out/<cell>.trace.json``, once a run: each
span's duration, its self time (the duration less the ``zs.*`` spans
directly inside it) and the benchmark stage (``bench.warmup``,
``bench.sample``, ``bench.ess``) it starts in. A program without these
spans gives none, and the metrics that read them give nothing.

    python3 -m benchmark.program_spans benchmark/_out/<cell>.trace.json

prints, for a trace, each stage's length, every span's count and times by
stage, and the device's idle gaps summed by the innermost ``zs.*`` span open on the host
at the launch that ends each gap.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
STAGES = ("bench.warmup", "bench.sample", "bench.ess")


def trace_path(cell: str) -> str:
    """Where the traced run writes the profiled job's chrome trace."""
    return os.path.join(BENCH_DIR, "_out", cell + ".trace.json")


class ProgramSpans:
    """The ``zs.*`` spans of one chrome trace, in start order; times in
    seconds. Each span is a dict: ``name``, ``ts``, ``end``, ``dur``,
    ``self``, ``stage`` and ``parent`` (the index of the ``zs.*`` span
    directly around it, or None)."""

    def __init__(self, events):
        # Nesting is decided on whole nanoseconds, the trace's own
        # resolution, so that a span starting as another ends is not
        # taken for its child by a rounding of seconds.
        notes, stages = [], {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") != "user_annotation":
                continue
            name = e.get("name", "")
            ts = round(float(e["ts"]) * 1e3)
            end = ts + round(float(e.get("dur", 0)) * 1e3)
            if name.startswith("zs."):
                notes.append({"name": name, "ts": ts, "end": end,
                              "self": end - ts,
                              "thread": (e.get("pid"), e.get("tid"))})
            elif name in STAGES:
                stages[name] = (ts, end)
        notes.sort(key=lambda s: (s["ts"], s["ts"] - s["end"]))
        open_spans = {}
        for i, s in enumerate(notes):
            stack = open_spans.setdefault(s.pop("thread"), [])
            # Spans of a thread nest: the innermost still open when this
            # one starts is its parent.
            while stack and notes[stack[-1]]["end"] <= s["ts"]:
                stack.pop()
            s["parent"] = stack[-1] if stack else None
            if stack:
                notes[stack[-1]]["self"] -= s["end"] - s["ts"]
            stack.append(i)
            s["stage"] = next((n for n, (a, b) in stages.items()
                               if a <= s["ts"] <= b), None)
        for s in notes:
            s["dur"] = 1e-9 * (s["end"] - s["ts"])
            s["self"] *= 1e-9
            s["ts"] *= 1e-9
            s["end"] *= 1e-9
        self.spans = notes
        self.stages = {n: (1e-9 * a, 1e-9 * b) for n, (a, b) in
                       stages.items()}
        self._starts = [s["ts"] for s in notes]

    @classmethod
    def load(cls, path: str) -> "ProgramSpans":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def named(self, prefix: str, stage=None):
        """The spans whose name starts with ``prefix`` (a whole name or a
        ``zs.adapt.``-style family), in ``stage`` when one is given."""
        return [s for s in self.spans if s["name"].startswith(prefix)
                and (stage is None or s["stage"] == stage)]

    def innermost(self, t: float):
        """The innermost span open at time ``t``, or None: the last span
        to start by ``t``, or the nearest of its enclosing spans still
        open (spans nest, so every span open at ``t`` encloses it)."""
        i = bisect.bisect_right(self._starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s["end"] < t:
            s = None if s["parent"] is None else self.spans[s["parent"]]
        return s


def of(run):
    """The run's program spans, read from its profiled job's trace once
    and kept on ``run``; None where the trace holds no ``zs.*`` span."""
    if not hasattr(run, "program_spans"):
        found = ProgramSpans.load(trace_path(run.cell["name"]))
        run.program_spans = found if found.spans else None
    return run.program_spans


def mean_us(spans, key: str):
    """Mean of the spans' ``key`` (``dur`` or ``self``) in microseconds;
    None for no span."""
    if not spans:
        return None
    return 1e6 * statistics.fmean(s[key] for s in spans)


# --------------------------------------------------------------- report
def span_table(found: ProgramSpans):
    """``[(stage, name, count, total s, mean us, mean self us)]``."""
    groups = {}
    for s in found.spans:
        groups.setdefault((s["stage"] or "-", s["name"]), []).append(s)
    return [(stage, name, len(g), sum(s["dur"] for s in g),
             mean_us(g, "dur"), mean_us(g, "self"))
            for (stage, name), g in sorted(groups.items())]


def idle_gaps(path: str, found: ProgramSpans):
    """The device's idle time in the job, summed by what the host was in
    when it launched the operation that ends each gap: ``{"<stage> /
    <innermost zs.* span>": seconds}`` (``-`` where no span was open)."""
    from benchmark.tracing import Trace

    trace = Trace(path)
    lo, hi = trace.window()
    gaps, end = {}, lo
    for o in trace.ops:
        if o["ts"] > end and lo <= o["ts"] <= hi:
            t = o["launch"] if o["launch"] is not None else o["ts"]
            inner = found.innermost(t)
            stage = next((n for n, (a, b) in found.stages.items()
                          if a <= t <= b), "bench.job")
            label = "{} / {}".format(stage, inner["name"] if inner else "-")
            gaps[label] = gaps.get(label, 0.0) + o["ts"] - end
        end = max(end, o["end"])
    if hi > end:
        gaps["bench.job / after the last device operation"] = hi - end
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def main(paths) -> int:
    for path in paths:
        found = ProgramSpans.load(path)
        print("== {}: {} zs.* spans".format(path, len(found.spans)))
        for stage, (a, b) in found.stages.items():
            print("{} {:.4f} ms".format(stage, 1e3 * (b - a)))
        print("stage name count total_ms mean_us mean_self_us")
        for stage, name, n, total, mean, own in span_table(found):
            print("{} {} {} {:.4f} {:.3f} {:.3f}".format(
                stage, name, n, 1e3 * total, mean, own))
        print("idle gap by host span: ms")
        for label, seconds in idle_gaps(path, found).items():
            print("{}: {:.4f}".format(label, 1e3 * seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
