"""Where the time goes on the SGMCMC paths (``PERF.md`` section 5).

Runs each sampler of ``chip_smoke.SG_SAMPLERS`` through ``init`` and
``run`` on ``bench.py``'s target (diagonal Gaussian, std
``linspace(0.1, 1.0)``, ``chip_smoke.DIM`` dims) at ``--chains`` chains,
float32, on the kernel path and on the plain path. From a warm state it
times ``--iters`` sampling iterations (every ``SG_THINNING``-th kept, as
``chip_smoke.py`` phase 13 does) without the profiler, then once more
under ``torch.profiler``, and prints one JSON line per path: wall time per
iteration, device time per iteration (the sum of the device activities'
durations), the busy share (device over wall), device activities per
iteration and the largest one with its time per launch. Needs a CUDA
device:

    python3 scripts/profile_sgmcmc.py [--chains 32768] [--iters 200]
"""

import argparse
import collections
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import zhusuan_tpu_torch as zt  # noqa: E402


def measure(name, fused, chains, iters, dev):
    std = torch.linspace(0.1, 1.0, chip_smoke.DIM, device=dev)
    dens = zt.DiagonalGaussianLogJoint(
        "x", torch.zeros(chip_smoke.DIM, device=dev), std)
    sampler = getattr(zt, name)(
        experimental_fused_step="auto" if fused else False,
        **chip_smoke.SG_SAMPLERS[name])
    state = sampler.init(
        {"x": torch.zeros(chains, chip_smoke.DIM, device=dev)},
        key=torch.Generator().manual_seed(60))
    key = torch.Generator().manual_seed(61)

    def sample():
        return sampler.run(dens, {}, state, key, iters,
                           thinning=chip_smoke.SG_THINNING)

    state, _ = sampler.run(dens, {}, state, key, 200, collect=False)
    sample()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sample()
        torch.cuda.synchronize()
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    rec = {"sampler": name, "path": "kernel" if fused else "plain",
           "chains": chains, "iters": iters, "wall_ms_per_iter": wall * 1e3}
    if not per_name:
        rec["device"] = "not measured: the profiler recorded no device time"
        return rec
    device = sum(ms for _, ms in per_name.values()) / iters
    top, (count, ms) = max(per_name.items(), key=lambda kv: kv[1][1])
    rec.update({
        "device_ms_per_iter": device,
        "busy": device / (wall * 1e3),
        "device_ops_per_iter": sum(n for n, _ in per_name.values()) / iters,
        "largest": {"name": top[:80], "ms_per_iter": ms / iters,
                    "ms_per_launch": ms / count,
                    "share_of_device": ms / iters / device}})
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=chip_smoke.SG_CHAINS)
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_sgmcmc.py needs a CUDA device.")
    dev = torch.device("cuda", 0)
    for name in chip_smoke.SG_SAMPLERS:
        for fused in (True, False):
            print(json.dumps(measure(name, fused, args.chains, args.iters,
                                     dev)), flush=True)


if __name__ == "__main__":
    main()
