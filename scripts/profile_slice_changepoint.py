"""Where the time goes on the card in the host-bound loops of this slice
(PERF.md section 5): a slice-sampler sweep at 4096 x 10, a change-point
sweep (the example's Gibbs sampler at its defaults), a replica-exchange
iteration at 8 x 4096 x 2 and an L-BFGS iteration of Laplace on
``bench.py``'s 100-dim target in float64 (chip_smoke.py phases 32-33's
shapes).

Each is run once to warm up, then a few times under ``torch.profiler``:
wall time per unit, device (kernel) time per unit and its share of the
wall (the rest is the host: launches, Python, host reads), kernels
launched per unit, host reads per unit (``aten::_local_scalar_dense``, the
op behind ``bool()`` / ``float()`` of a card tensor) and stream
synchronisations per unit (``cudaStreamSynchronize``, which every read of
the card also makes, ``.tolist()`` included), and the five ops with the
most host time. Prints one JSON line per loop and
writes them to ``chiprun_out/profile_slice_changepoint.json``.

    python3 scripts/profile_slice_changepoint.py
"""

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import zhusuan_tpu_torch as zt  # noqa: E402


def measure(name, fn, units):
    """Profile ``fn`` (which does ``units`` units of work)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    reads = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    syncs = sum(1 for e in events if e.name == "cudaStreamSynchronize")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    rec = {"loop": name, "units": units,
           "wall_ms_per_unit": wall / units * 1e3,
           "device_ms_per_unit": device_us / units / 1e3,
           "device_share": device_us / 1e6 / wall,
           "kernels_per_unit": len(kernels) / units,
           "host_reads_per_unit": reads / units,
           "stream_syncs_per_unit": syncs / units,
           "top_host_ops": [[e.key, e.count // units,
                             e.self_cpu_time_total / units / 1e3]
                            for e in top[:5]]}
    print(json.dumps(rec), flush=True)
    return rec


def main(device="cuda:0"):
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        print(cs.phase_device(torch), flush=True)
    recs = []
    g = torch.Generator(device=dev).manual_seed(0)

    sstd = torch.linspace(0.1, 1.0, cs.SLICE_DIM, device=dev)
    sdens = zt.DiagonalGaussianLogJoint(
        "x", torch.zeros(cs.SLICE_DIM, device=dev), sstd)
    slice_ = zt.SliceSampler()
    st = slice_.init({"x": sstd * torch.randn(
        cs.SLICE_CHAINS, cs.SLICE_DIM, generator=g, device=dev)}, 1)
    recs.append(measure("slice sweep 4096 x 10", lambda: slice_.run(
        sdens, {}, st, (1, 0), 5, collect=False), 5))

    from zhusuan_tpu_torch.examples.state_space import changepoint
    with open(cs.CHANGEPOINT_REFERENCE) as f:
        y = torch.tensor(json.load(f)["y"], dtype=torch.float64, device=dev)
    recs.append(measure("changepoint sweep (64 chains, t 60)",
                        lambda: changepoint.run(y=y, n_iters=40, burnin=20),
                        40))

    def bimodal(obs):
        z = obs["z"]
        return torch.logaddexp(-0.5 * torch.sum((z - cs.REMC_MU) ** 2, -1),
                               -0.5 * torch.sum((z + cs.REMC_MU) ** 2, -1))

    remc = zt.ReplicaExchangeHMC(step_size=0.2, n_leapfrogs=10,
                                 n_temps=cs.REMC_TEMPS,
                                 min_beta=cs.REMC_MIN_BETA)
    rst = remc.init({"z": torch.full((cs.REMC_CHAINS, 2), cs.REMC_MU,
                                     device=dev)}, bimodal)
    recs.append(measure("replica exchange iteration 8 x 4096 x 2",
                        lambda: remc.run(bimodal, {}, rst, (2, 0), 20,
                                         n_adapt=20), 20))

    from zhusuan_tpu_torch.variational import laplace_approximation
    std = torch.linspace(0.1, 1.0, cs.DIM, dtype=torch.float64, device=dev)
    dens = zt.DiagonalGaussianLogJoint(
        "x", torch.zeros(cs.DIM, dtype=torch.float64, device=dev), std)
    x0 = 2.0 * torch.randn(cs.DIM, generator=g, dtype=torch.float64,
                           device=dev)
    recs.append(measure("Laplace L-BFGS iteration (100 dims, float64)",
                        lambda: laplace_approximation(dens, {}, {"x": x0},
                                                      n_iters=100), 100))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_slice_changepoint.json"), "w") as f:
        json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
