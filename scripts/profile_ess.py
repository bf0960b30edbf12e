"""The ESS check of the benchmark's 32768-chain cells on the card: the
one-pass kernel (``ops/ess.py::fused_ess``) against the batched FFT path it
replaced (``diagnostics._ess_fft``), on the draws of one job of each cell.

For each cell (``hmc.neal100d.32k``: [500, 32768 x 100] bfloat16;
``nuts.neal100d.32k``: [300, 32768 x 100] float32) it runs one job of the
cell's recipe (``benchmark/workloads/<cell>.json`` through the benchmark's
own sampler driver) at ``--seed``, then times both paths with CUDA events
(``--reps`` calls each, after an untimed one) and prints one JSON line: each
path's ms a call, the bound (``chip_smoke._ess_bound``: the draws read
once, or the estimator's multiply-adds up to each cutoff), each path's job
total (each chain's minimum over
dimensions, summed) against the float64 estimator's, and the distribution
of the cutoff, the lag of each column's first negative rho (from float32
autocovariances). Needs a CUDA device:

    python3 scripts/profile_ess.py [--seed 7] [--reps 10] [--cells ...]
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.reference.ess import ess_total  # noqa: E402
from zhusuan_tpu_torch import diagnostics  # noqa: E402
from zhusuan_tpu_torch.ops.ess import fused_ess  # noqa: E402

CELLS = ("hmc.neal100d.32k", "nuts.neal100d.32k")


def _draws(name, seed, dev):
    cell, config = harness.load_cell(name)
    driver = harness.module("samplers", cell["sampler"])
    ctx = {"cell": cell, "config": config, "device": dev, "seed": seed}
    driver.build(ctx)
    rec = harness.run_job(torch, driver, ctx, 0)
    if rec["failed"]:
        raise RuntimeError("the job failed: {}".format(rec.get("error")))
    draws = rec["keep"]["samples"]
    harness.module("samplers", cell["sampler"]).release(ctx)
    return draws


def _ms(fn, x, reps):
    fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _total(ess, c, d):
    return float(ess.reshape(c, d).min(dim=1).values.double().sum())


def measure(name, seed, reps, dev):
    draws = _draws(name, seed, dev)
    n, c, d = draws.shape
    x = draws.reshape(n, c * d)
    kernel_ms = _ms(fused_ess, x, reps)
    fft_ms = _ms(diagnostics._ess_fft, x, reps)
    ref = ess_total(draws, c)
    kernel_total = _total(fused_ess(x), c, d)
    fft_total = _total(diagnostics._ess_fft(x), c, d)
    cut = chip_smoke._cutoffs(torch, x).double()
    qs = torch.quantile(cut[torch.randperm(cut.numel(), device=dev)[:1 << 20]],
                        torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                     device=dev))
    bound = chip_smoke._ess_bound(torch, n, x.element_size(), cut)
    return {
        "cell": name, "shape": [n, c * d], "dtype": str(x.dtype),
        "kernel_ms": kernel_ms, "fft_ms": fft_ms, **bound,
        "kernel_over_bound": kernel_ms / bound["bound_ms"],
        "fft_over_kernel": fft_ms / kernel_ms,
        "total_ref": ref, "kernel_total_gap": abs(kernel_total - ref) / ref,
        "fft_total_gap": abs(fft_total - ref) / ref,
        "cutoff_mean": float(cut.mean()),
        "cutoff_p50_p90_p99": [float(v) for v in qs],
        "cutoff_max": float(cut.max()),
        "share_past_first_pass": float((cut >= 8).double().mean()),
        "launches": fused_ess.launches,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--cells", nargs="+", default=list(CELLS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card: " + card.strip(), file=sys.stderr)
    for name in args.cells:
        out = measure(name, args.seed, args.reps, dev)
        out["card"] = card.strip()
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
