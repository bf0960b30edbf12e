"""Where the time goes in an SVGP training step (``PERF.md`` section 5).

Builds ``chip_smoke.py`` phase 15's recipe through the port's SVGP module
(``zhusuan_tpu_torch/examples/gaussian_process/svgp.py``: 456 x 13
synthetic rows from data seed 42, 100 inducing points, 20 particles, full
batch, ``Adam(1e-2)``, float32) and, with ``--protein``, the Protein-size
step as well (the 45730 x 9 synthetic fallback, minibatches of 5000 rows).
For each size and each path (kernel: ``kzz_factors``, which launches the
Cholesky-plus-inverse kernel; plain: ``kzz_cholesky`` and triangular
solves) it takes 30 warm-up steps, times ``--steps`` steps without the
profiler, then ``--steps`` more under ``torch.profiler``, and prints one
JSON line: wall time per step, device time per step (the sum of the
device activities' durations), the busy share (device over wall), device
activities per step, the Cholesky-plus-inverse kernel's time per launch
and the largest device activity. Needs a CUDA device:

    python3 scripts/profile_svgp.py [--steps 100] [--protein]
"""

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from zhusuan_tpu_torch.examples.gaussian_process import svgp  # noqa: E402

WARMUP = 30
PROTEIN_BATCH = 5000  # svgp.py's -batch_size


def _boston(dev):
    x_train, y_train, _, _, _ = svgp.regression_splits(svgp.SVGP_CONFIG)
    x, y = (torch.as_tensor(v, device=dev) for v in (x_train, y_train))
    return x_train, len(x_train), lambda t: (x, y)


def _protein(dev):
    x_tr, y_tr, x_va, y_va, x_te, y_te, _ = svgp.load_uci_protein_data()
    x_train, _, _, _ = svgp.standardize(np.vstack([x_tr, x_va]), x_te)
    y_train, _, _, _ = svgp.standardize(np.hstack([y_tr, y_va]), y_te)
    x_train = x_train.astype(np.float32)
    y_train = y_train.astype(np.float32)
    n_train = len(x_train)
    perm = np.random.RandomState(1).permutation(n_train)
    xd = torch.as_tensor(x_train, device=dev)
    yd = torch.as_tensor(y_train, device=dev)
    batches = []
    for t in range(n_train // PROTEIN_BATCH):
        idx = torch.as_tensor(perm[t * PROTEIN_BATCH:(t + 1) * PROTEIN_BATCH],
                              device=dev)
        batches.append((xd[idx], yd[idx]))
    return x_train, n_train, lambda t: batches[t % len(batches)]


def measure(size, chol_inverse, steps, dev):
    x_train, n_train, batch = (_boston if size == "boston"
                               else _protein)(dev)
    cfg = svgp.SVGP_CONFIG
    params = svgp.init_params(cfg["n_z"], x_train.shape[1], x_train,
                              device=dev)
    optimizer = svgp.make_optimizer(params, cfg["lr"])
    keys = iter(svgp.step_keys(5, WARMUP + 2 * steps))

    def run(n):
        for t in range(n):
            x, y = batch(t)
            lb = svgp.train_step(params, optimizer, x, y, cfg["n_z"],
                                 cfg["n_particles"], n_train, next(keys),
                                 chol_inverse=chol_inverse)
        torch.cuda.synchronize()
        return lb

    run(WARMUP)
    t0 = time.perf_counter()
    lb = run(steps)
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    per_name = collections.defaultdict(lambda: [0, 0.0])
    events = prof.events()
    # A host-side annotation (the optimizer's "Optimizer.step#...") also
    # shows as a device span covering the kernels under it: kernels and
    # copies have names no host event carries.
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in host_names:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    rec = {"size": size, "path": "kernel" if chol_inverse else "plain",
           "rows_per_step": len(batch(0)[0]), "steps": steps,
           "wall_ms_per_step": wall * 1e3, "final_bound": float(lb)}
    if not per_name:
        rec["device"] = "not measured: the profiler recorded no device time"
        return rec
    device = sum(ms for _, ms in per_name.values()) / steps
    top, (count, ms) = max(per_name.items(), key=lambda kv: kv[1][1])
    chol = [(n, c, t) for n, (c, t) in per_name.items()
            if "chol_inv_kernel" in n]
    rec.update({
        "device_ms_per_step": device,
        "busy": device / (wall * 1e3),
        "device_ops_per_step": sum(n for n, _ in per_name.values()) / steps,
        "largest": {"name": top[:80], "ms_per_step": ms / steps,
                    "ms_per_launch": ms / count,
                    "share_of_device": ms / steps / device}})
    if chol:
        _, count, ms = chol[0]
        rec["cholesky_inverse"] = {"launches_per_step": count / steps,
                                   "ms_per_launch": ms / count,
                                   "share_of_device": ms / steps / device}
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--protein", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_svgp.py needs a CUDA device.")
    dev = torch.device("cuda", 0)
    for size in ("boston", "protein") if args.protein else ("boston",):
        for chol_inverse in (True, False):
            print(json.dumps(measure(size, chol_inverse, args.steps, dev)),
                  flush=True)


if __name__ == "__main__":
    main()
