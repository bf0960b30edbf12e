"""Where the time goes in an ADVI fit (``PERF.md`` section 5).

Runs ``zhusuan_tpu_torch.variational.advi`` at the two sizes of
``chip_smoke.py`` phase 18: the toy2d recipe (the built-in toy2d posterior,
500 particles, Adam at a constant 0.1 from loc -2, log-scale -5) and
``advi()``'s defaults with 64 particles on ``bench.py``'s 100-dim diagonal
Gaussian. For each size and each path (kernel: the whole fit as one launch
of the CUDA trainer; plain: the Python loop ``guide.latent`` ->
``elbo().sgvb()`` -> backward -> Adam) it runs a fit of ``--steps`` steps
untimed, one timed without the profiler and one under ``torch.profiler``,
and prints one JSON line: wall time per step, device time per step (the sum
of the kernels' and copies' durations), the busy share (device over wall),
device activities per step and the largest device activity. With ``--host``
it also prints the plain path's host functions by cumulative time
(``cProfile``). Needs a CUDA device:

    python3 scripts/profile_advi.py [--steps 500] [--host]
"""

import argparse
import cProfile
import collections
import io
import json
import os
import pstats
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from zhusuan_tpu_torch import ops, variational  # noqa: E402


def _toy2d(dev, fused, steps):
    dens = ops.Toy2DLogJoint("z", chip_smoke.TOY2D_SCALE)
    guide = variational.MeanFieldGuide(dens, device=dev)
    init = guide.init_params()
    init["loc"]["z"].fill_(chip_smoke.TOY2D_INIT[0])
    init["log_scale"]["z"].fill_(chip_smoke.TOY2D_INIT[1])
    return lambda: variational.advi(
        dens, {}, (1, 2), guide=guide, n_iters=steps,
        n_samples=chip_smoke.TOY2D_PARTICLES,
        lr_schedule=lambda t: chip_smoke.TOY2D_LR, init_params=init,
        experimental_fused=fused)


def _gaussian(dev, fused, steps):
    dens, _, _, _ = chip_smoke._advi_density(torch, dev, "diagonal",
                                             chip_smoke.DIM)
    return lambda: variational.advi(
        dens, {}, (1, 2), n_iters=steps,
        n_samples=chip_smoke.GAUSS_PARTICLES, device=dev,
        experimental_fused=fused)


def measure(size, fused, steps, dev, host):
    fit = (_toy2d if size == "toy2d" else _gaussian)(dev, fused, steps)

    def run():
        res = fit()
        torch.cuda.synchronize()
        return res

    run()
    t0 = time.perf_counter()
    res = run()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
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
    rec = {"size": size, "path": "kernel" if fused else "plain",
           "steps": steps, "wall_ms_per_step": wall * 1e3,
           "wall_ms_per_fit": wall * steps * 1e3,
           "final_loss": float(res.losses[-1])}
    if not per_name:
        rec["device"] = "not measured: the profiler recorded no device time"
    else:
        device = sum(ms for _, ms in per_name.values()) / steps
        top, (count, ms) = max(per_name.items(), key=lambda kv: kv[1][1])
        rec.update({
            "device_ms_per_step": device,
            "busy": device / (wall * 1e3),
            "device_ops_per_step": sum(n for n, _ in per_name.values())
            / steps,
            "largest": {"name": top[:80], "ms_per_step": ms / steps,
                        "ms_per_launch": ms / count,
                        "share_of_device": ms / steps / device}})
    print(json.dumps(rec), flush=True)
    if host and not fused:
        prof = cProfile.Profile()
        prof.enable()
        run()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(
            25)
        print(out.getvalue())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--host", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_advi.py needs a CUDA device.")
    dev = torch.device("cuda", 0)
    for size in ("toy2d", "gaussian"):
        for fused in (True, False):
            measure(size, fused, args.steps, dev, args.host)


if __name__ == "__main__":
    main()
