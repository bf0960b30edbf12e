"""Where the time goes in a training step of the VAE, IWAE and SBN paths,
of the toy2d and BNN configurations and of the Bernoulli-latent,
Gumbel-softmax and convolutional VAEs and variational dropout
(``PERF.md`` section 5).

The VAE runs the main path of ``chip_smoke.py`` phase 19,
``vae.fit_protocol`` (784-500-500-40, batch 128, one particle, the VAE
protocol's permutations and dynamic binarization, one ``fit_scan`` epoch of
78 steps at a time): one warm-up epoch, then ``E`` epochs timed without the
profiler and ``E`` under it, ``E = ceil(--steps / 78)``. The other paths
run their example's own train step at the full width of phases 20-22
(``zhusuan_tpu_torch/examples/acceptance.py``'s step builders): the IWAE
(the VAE's nets, k = 50, batch 64), the SBN with VIMCO (784-200-200-200,
k = 10, batch 24), toy2d SGVB (500 particles), the BNN with SGVB ([13, 50,
1], batch 10, 10 particles) and with SGHMC ([9, 50, 1], batch 100, 20
particles), and the four training examples at their full widths (batch
128; variational dropout batch 1000, 10 particles): 30 warm-up steps,
``--steps`` steps timed without the
profiler, then ``--steps`` more under ``torch.profiler``. Each path prints
one JSON line: wall time per step, device time per step (the sum of the
device activities' durations), the busy share (device over wall), device
activities per step and the largest device activity. Needs a CUDA device:

    python3 scripts/profile_vae_sbn.py [--steps 200] [path ...]
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

from zhusuan_tpu_torch.examples.acceptance import STEPS  # noqa: E402
from zhusuan_tpu_torch.examples.utils import protocols  # noqa: E402
from zhusuan_tpu_torch.examples.variational_autoencoders import (  # noqa: E402
    vae,
)

WARMUP = 30
PATHS = ("vae",) + tuple(STEPS)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def measure_vae(steps, dev):
    """``vae.fit_protocol`` whole epochs: the callback after each epoch
    (its losses already read, so the device is idle) starts and stops the
    profiler."""
    per_epoch = protocols.VAE_N_TRAIN // protocols.VAE_BATCH
    n = -(-steps // per_epoch)
    prof = _profiler()
    timed = []

    def on_epoch(epoch, lower_bound, seconds):
        if 2 <= epoch <= 1 + n:
            timed.append(seconds)
        if epoch == 1 + n:
            prof.start()
        elif epoch == 1 + 2 * n:
            prof.stop()

    _, curve, _ = vae.fit_protocol(dev, epochs=1 + 2 * n, callback=on_epoch)
    return _record("vae", prof, n * per_epoch, sum(timed) / (n * per_epoch),
                   curve[-1])


def measure(path, steps, dev):
    if path == "vae":
        return measure_vae(steps, dev)
    step, _ = STEPS[path](dev, WARMUP + 2 * steps)
    t = 0

    def run(n):
        nonlocal t
        for _ in range(n):
            out = step(t)
            t += 1
        torch.cuda.synchronize()
        return out

    run(WARMUP)
    t0 = time.perf_counter()
    last = run(steps)
    wall = (time.perf_counter() - t0) / steps
    with _profiler() as prof:
        run(steps)
    return _record(path, prof, steps, wall, last)


def _record(path, prof, steps, wall, last):
    """The JSON record of ``steps`` profiled steps; ``wall`` is seconds a
    step without the profiler."""
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
    rec = {"path": path, "steps": steps, "wall_ms_per_step": wall * 1e3,
           "last_metric": float(last)}
    if not per_name:
        rec["device"] = "not measured: the profiler recorded no device time"
        return rec
    device = sum(ms for _, ms in per_name.values()) / steps
    top, (count, ms) = max(per_name.items(), key=lambda kv: kv[1][1])
    rec.update({
        "device_ms_per_step": device,
        "busy": device / (wall * 1e3),
        "device_ops_per_step": sum(n for n, _ in per_name.values()) / steps,
        "largest": {"name": top[:80], "ms_per_step": ms / steps,
                    "ms_per_launch": ms / count,
                    "share_of_device": ms / steps / device}})
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("paths", nargs="*", metavar="path",
                        help="any of {} (default: all)".format(
                            ", ".join(PATHS)))
    args = parser.parse_args()
    unknown = set(args.paths) - set(PATHS)
    if unknown:
        parser.error("unknown paths: {}".format(sorted(unknown)))
    if not torch.cuda.is_available():
        sys.exit("profile_vae_sbn.py needs a CUDA device.")
    dev = torch.device("cuda", 0)
    for path in args.paths or PATHS:
        print(json.dumps(measure(path, args.steps, dev)), flush=True)


if __name__ == "__main__":
    main()
