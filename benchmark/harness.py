"""One run of one cell: set-up, the closed loop of inference jobs over the
window, the check of a job against the plain reference, and the result.

Everything is found by name: the cell ``workloads/<cell>.json`` names its
configuration ``configs/<config>.json`` and its sampler's job driver
``samplers/<sampler>.py``, whose reference is ``reference/<sampler>.py``;
the configuration names its target, the posterior it samples, whose
program side is ``targets/<target>.py`` and whose plain side is
``reference/targets/<target>.py``; a per-layer metric is any
``metrics/<metric>.py`` whose reader finds something to read, and a
kernel's least time comes from ``roofline/<kernel>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "zhusuan_tpu")
MASK64 = 0xFFFFFFFFFFFFFFFF
# The warm job of set-up and the job the traced run profiles.
WARM_JOB = 1 << 40
PROFILED_JOB = 3


class Refused(Exception):
    """The run cannot give a result (no card, a job that raised...)."""


# ----------------------------------------------------------------- files
def load_json(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, name + ".json")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """``(cell, config)`` of the cell ``name``."""
    cell = load_json("workloads", name)
    cell["name"] = name
    return cell, load_json("configs", cell["config"])


def context(cell, config, device, seed: int):
    """What a cell's driver reads: the cell, its configuration, both sides
    of its target (``target``: ``targets/<target>.py``; ``plain``:
    ``reference/targets/<target>.py``), the device and the seed."""
    return {"cell": cell, "config": config,
            "target": module("targets", config["target"]),
            "plain": module("reference/targets", config["target"]),
            "device": device, "seed": int(seed)}


def names(kind: str, ext: str):
    """The names of the files ``<kind>/*<ext>``, sorted."""
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(BENCH_DIR,
                                                                 kind))
                  if f.endswith(ext) and not f.startswith("_"))


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (``kind`` may name a subdirectory,
    as ``reference/targets``)."""
    return importlib.import_module("benchmark.{}.{}".format(
        kind.replace("/", "."), name))


def metric_modules():
    return [module("metrics", n) for n in names("metrics", ".py")]


# ------------------------------------------------------------ arithmetic
def _mix(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def job_words(seed: int, index: int, salt: int = 0) -> int:
    """64 bits from ``(seed, job, salt)``; any whole seed."""
    z = _mix((int(seed) * 0x9E3779B97F4A7C15 + salt) & MASK64)
    return _mix((z + (int(index) + 1) * 0xD1B54A32D192ED03) & MASK64)


def job_key(seed: int, index: int):
    """The Philox key of a job, ``(k0, k1)``."""
    z = job_words(seed, index, 1)
    return z >> 32, z & 0xFFFFFFFF


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` of
    the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def window_metrics(jobs, window_s: float, cell):
    """The end-to-end metrics of a window of job records: ESS and draws
    over the whole window, the 90th percentile of every job's wall time
    (a failed job counts as over any limit)."""
    draws_per_job = cell["chains"] * (cell["n_warmup"] + cell["n_sample"])
    done = [j for j in jobs if not j["failed"]]
    times = [j["seconds"] if not j["failed"] else math.inf for j in jobs]
    return {
        "ess_per_s": sum(j["ess"] for j in done) / window_s,
        "draws_per_s": draws_per_job * len(done) / window_s,
        "job_p90_s": percentile(times, 0.9),
    }


def process_age() -> float:
    """Seconds since this process started, from ``/proc``."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# ---------------------------------------------------------------- spans
class Spans:
    """Host-clock spans of one job's stages. In the traced run each stage
    ends with a synchronize, and in the profiled job it is also a
    ``torch.profiler`` annotation ``bench.<stage>``."""

    def __init__(self, torch, sync: bool, annotate: bool):
        self.torch, self.sync, self.annotate = torch, sync, annotate
        self.seconds = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        note = (self.torch.profiler.record_function("bench." + name)
                if self.annotate else contextlib.nullcontext())
        start = time.perf_counter()
        with note:
            yield
            if self.sync:
                self.torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - start


# ----------------------------------------------------------------- jobs
def run_job(torch, driver, ctx, index: int, sync=False, annotate=False):
    """One inference job; returns its record (``failed`` when it raised
    or its ESS is not a positive number)."""
    rec = {"index": index, "failed": False}
    spans = Spans(torch, sync, annotate)
    t0 = time.perf_counter()
    try:
        with spans.stage("job"):
            out = driver.job(ctx, index, spans)
    except (RuntimeError, ValueError, FloatingPointError) as err:
        rec.update(failed=True, error=repr(err), seconds=time.perf_counter()
                   - t0, ess=0.0)
        return rec
    rec["seconds"] = time.perf_counter() - t0
    rec.update(out)
    rec["spans"] = spans.seconds
    if not (math.isfinite(rec["ess"]) and rec["ess"] > 0):
        rec["failed"] = True
    return rec


class Reservoir:
    """The job a run checks, drawn from the seed uniformly among all the
    window's finished jobs by a reservoir of one: the ``k``-th job offered
    replaces the kept one with probability ``1 / k``."""

    def __init__(self, seed: int):
        self.pick = random.Random(job_words(seed, 0, 2))
        self.offered, self.kept = 0, None

    def offer(self, index: int, outputs):
        self.offered += 1
        if self.pick.randrange(self.offered) == 0:
            self.kept = (index, outputs)


def window(torch, driver, ctx, seconds: float, trace: bool):
    """Jobs back to back until ``seconds`` have passed; the window ends
    with its last job. Returns ``(records, window seconds, the checked
    job's ``(index, outputs)``, profile)``."""
    jobs, prof = [], None
    checked = Reservoir(ctx["seed"])
    start = time.perf_counter()
    while True:
        index = len(jobs)
        if trace and index == PROFILED_JOB:
            rec, prof = profile_job(torch, driver, ctx, index)
        else:
            rec = run_job(torch, driver, ctx, index, sync=trace)
        keep = rec.pop("keep", None)
        if keep is not None:
            checked.offer(index, keep)
        del keep
        jobs.append(rec)
        if time.perf_counter() - start >= seconds:
            break
    return jobs, time.perf_counter() - start, checked.kept, prof


def profile_job(torch, driver, ctx, index: int):
    """Run one job under ``torch.profiler`` (host and device), its stages
    annotated; returns ``(record, chrome trace path)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rec = run_job(torch, driver, ctx, index, sync=True, annotate=True)
    out_dir = os.path.join(BENCH_DIR, "_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ctx["cell"]["name"] + ".trace.json")
    prof.export_chrome_trace(path)
    rec["profiled"] = True
    return rec, path


# ----------------------------------------------------------- the check
def judge(numbers, limits):
    """``(correct, {name: {"value", "limit"}})``: every number at or below
    its limit (a missing or non-finite number fails)."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state() -> str:
    """The card's name and power limit, and its clocks, temperature, draw
    and throttle reasons as ``nvidia-smi`` reads them."""
    query = ("name,power.limit,clocks.sm,clocks.mem,temperature.gpu,"
             "power.draw,clocks_throttle_reasons.active")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + query, "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as err:
        return "not read ({})".format(err)
    return out.stdout.strip() or "not read"


def job_spread(times, window_s: float) -> str:
    """One line: the jobs' times within this run, their quartiles' spread
    as a share of their median (beside the spread across runs)."""
    ordered = sorted(times)
    if len(ordered) > 1:
        q1, med, q3 = statistics.quantiles(ordered, n=4)
    else:
        q1 = med = q3 = ordered[0]
    return ("jobs {} in {:.3f} s: min {:.4f} q1 {:.4f} median {:.4f} q3 "
            "{:.4f} max {:.4f} s; spread within the run {:.3f}%").format(
                len(ordered), window_s, ordered[0], q1, med, q3, ordered[-1],
                100.0 * (q3 - q1) / med)


# ----------------------------------------------------------------- main
def route_launches(driver) -> int:
    """The launch counter of the driver's kernel wrapper."""
    mod, name = driver.ROUTE.split(":")
    return getattr(importlib.import_module(mod), name).launches


def main(argv_args, t_start: float, age_at_start: float, device=None):
    """One run; ``device`` other than the card only in the tests, which
    stand in for the card's calls."""
    cell, config = load_cell(argv_args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < cell.get("chips", 1):
            raise Refused("the cell needs {} cards, {} found".format(
                cell.get("chips", 1), torch.cuda.device_count()))
        device = torch.device("cuda", 0)
    print("card: " + card_state(), file=sys.stderr)
    driver = module("samplers", cell["sampler"])
    ctx = context(cell, config, device, argv_args.seed)
    driver.build(ctx)
    warm = run_job(torch, driver, ctx, WARM_JOB)
    if warm["failed"]:
        print("the warm job failed: {}".format(warm.get("error")),
              file=sys.stderr)
    del warm
    gc.collect()
    torch.cuda.synchronize()
    setup_s = age_at_start + time.perf_counter() - t_start
    before = route_launches(driver)
    jobs, window_s, kept, trace_path = window(
        torch, driver, ctx, argv_args.seconds, argv_args.trace)
    torch.cuda.synchronize()
    print(job_spread([j["seconds"] for j in jobs], window_s), file=sys.stderr)
    print("card after the window: " + card_state(), file=sys.stderr)
    print("route {}: {} launches in the window's {} iterations".format(
        driver.ROUTE, route_launches(driver) - before,
        len(jobs) * (cell["n_warmup"] + cell["n_sample"])), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device)
    found = forbidden_modules()
    if found:
        raise Refused("modules of JAX or the JAX package are loaded: "
                      + ", ".join(found))
    result = {"attempted": len(jobs),
              "failed": sum(j["failed"] for j in jobs)}
    if argv_args.trace:
        from benchmark import tracing

        run = tracing.TracedRun(ctx, jobs, window_s, trace_path)
        result["metrics"], device_extra, breakdown = run.per_layer(
            metric_modules())
    else:
        metrics = window_metrics(jobs, window_s, cell)
        metrics["setup_s"] = setup_s
        units = {"ess_per_s": "ESS/s", "draws_per_s": "draws/s",
                 "job_p90_s": "s", "setup_s": "s"}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in metrics.items()}
        device_extra, breakdown = {}, None
    # The program's state is freed before the reference runs.
    driver.release(ctx)
    gc.collect()
    torch.cuda.empty_cache()
    reference = module("reference", cell["sampler"])
    numbers = {}
    if kept is not None:
        print("checked job {} of {}".format(kept[0], len(jobs)),
              file=sys.stderr)
        numbers = reference.check(kept[1], cell, config)
    correct, shown = judge(numbers, cell["limits"])
    correct = correct and result["failed"] == 0
    result["correct"] = correct
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0), "count": 1,
                        "memory_peak_bytes": int(peak), **device_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = shown
    for name, item in shown.items():
        print("check {} {} limit {}".format(name, item["value"],
                                            item["limit"]), file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["check"] = result["check"]
    print(json.dumps(line))
    return 0
