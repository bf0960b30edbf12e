"""What the traced run reads: the stage spans of every job, and the
profiler's trace of one job (the device's busy time, its operations by
name and by stage, the idle gaps and what the host was doing in them).

The spans are taken by the benchmark around its calls into the program,
each closed by a synchronize; the profiled job's own spans are left out
of the span averages, since the profiler slows its host side.
"""

from __future__ import annotations

import json
import re
import statistics

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """One job's chrome trace: device operations with the host launch
    that issued them, and the benchmark's annotations. Times in seconds."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        launches, self.ops, self.notes, self.cpu = {}, [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.ops.append({"name": name, "ts": ts, "end": ts + dur,
                                 "corr": corr})
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ts
            elif cat == "user_annotation" and name.startswith("bench."):
                self.notes[name] = (ts, ts + dur)
            elif cat == "cpu_op":
                self.cpu.append((ts, ts + dur, name))
        for op in self.ops:
            op["launch"] = launches.get(op["corr"])
        self.ops.sort(key=lambda o: o["ts"])

    def window(self):
        return self.notes.get("bench.job")

    def in_stage(self, stage: str):
        """Device operations that ran inside the stage's annotation (each
        stage ends with a synchronize, so its operations run within it)."""
        span = self.notes.get(stage)
        if span is None:
            return []
        return [o for o in self.ops if span[0] <= o["ts"] <= span[1]]

    def busy(self):
        lo, hi = self.window()
        return _union([(max(o["ts"], lo), min(o["end"], hi)) for o in self.ops
                       if o["end"] > lo and o["ts"] < hi])

    def kernels(self, pattern: str):
        """``[(name, seconds)]`` of the kernels whose name matches, in
        launch order."""
        rx = re.compile(pattern)
        return [(o["name"], o["end"] - o["ts"]) for o in self.ops
                if rx.search(o["name"])]

    def host_label(self, t: float) -> str:
        stage = next((n for n, (a, b) in self.notes.items()
                      if n != "bench.job" and a <= t <= b), "bench.job")
        inner = [c for c in self.cpu if c[0] <= t <= c[1]]
        op = min(inner, key=lambda c: c[1] - c[0])[2] if inner else "python"
        return "{} / {}".format(stage, op)

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing before the next launch."""
        by_name = {}
        for o in self.ops:
            took = o["end"] - o["ts"]
            by_name[o["name"]] = by_name.get(o["name"], 0.0) + took
        lo, hi = self.window()
        gaps, end = {}, lo
        for o in self.ops:
            if o["ts"] > end and lo <= o["ts"] <= hi:
                label = self.host_label(o["launch"] if o["launch"] is not None
                                        else o["ts"])
                gaps[label] = gaps.get(label, 0.0) + o["ts"] - end
            end = max(end, o["end"])
        if hi > end:
            gaps["bench.job / after the last device operation"] = hi - end
        order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in order],
                "idle_gaps": [[n[:160], s] for n, s in idle]}


class TracedRun:
    """What a metric's reader gets: the cell, its configuration, the
    dimension and the density's work per chain (``cost``) from its
    target's plain side, the per-job stage spans, the profiled job's
    record and its trace."""

    def __init__(self, ctx, jobs, window_s: float, trace_path: str):
        self.cell, self.config = ctx["cell"], ctx["config"]
        self.dim = ctx["plain"].dim(self.config)
        self.cost = ctx["plain"].cost(self.config)
        self.jobs = [j for j in jobs if not j["failed"]]
        self.window_s = window_s
        self.profiled = next(j for j in jobs if j.get("profiled"))
        self.trace = Trace(trace_path)

    def span_mean(self, name: str):
        """Mean seconds of a stage over the unprofiled jobs, or None."""
        vals = [j["spans"][name] for j in self.jobs
                if not j.get("profiled") and name in j.get("spans", {})]
        return statistics.fmean(vals) if vals else None

    def per_layer(self, modules):
        metrics = {}
        for m in modules:
            value = m.read(self)
            if value is not None:
                metrics[m.NAME] = {"value": value, "unit": m.UNIT}
        lo, hi = self.trace.window()
        device = {"busy_s": self.trace.busy(), "window_s": hi - lo}
        return metrics, device, self.trace.breakdown()
