"""The readings a cell's limits are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3

For each seed, one job of the cell at its own size, checked against the
float64 reference as a run checks it (the lower readings). For each
control seed, the same job with the reference computed in the precision
just below the configuration's put in the program's place
(``reference.<sampler>.stand_in``), then checked and judged against the
cell's limits the same way (the upper readings; each has to come out not
correct). One JSON line a reading; the runs of the benchmark do not run
this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The precision just below each one a configuration states.
LOWER = {"float64": "float32", "float32": "bfloat16"}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args()
    sys.path[0] = ROOT
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell, config = harness.load_cell(args.workload)
    driver = harness.module("samplers", cell["sampler"])
    reference = harness.module("reference", cell["sampler"])
    lower = getattr(torch, LOWER[config["precision"]])
    ctx = harness.context(cell, config, torch.device("cuda", 0), 0)
    driver.build(ctx)
    runs = [("program", s) for s in args.seeds]
    runs += [("control", s) for s in args.control_seeds]
    for kind, seed in runs:
        ctx["seed"] = seed
        rec = harness.run_job(torch, driver, ctx, 0)
        if rec["failed"]:
            print(json.dumps({"kind": kind, "seed": seed,
                              "error": rec.get("error")}))
            continue
        t0 = time.perf_counter()
        job = rec.pop("keep")
        if kind == "control":
            job = reference.stand_in(job, cell, config, lower)
        numbers = reference.check(job, cell, config)
        correct, _ = harness.judge(numbers, cell["limits"])
        del job
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "correct": correct, "job_s": rec["seconds"],
                          "ess": rec["ess"],
                          "reference_s": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
