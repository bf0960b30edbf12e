"""Host microseconds per kernel launch through the port's launch path.

Run on a machine with one NVIDIA GPU and ``nvcc``, from the repository
root: ``python3 scripts/launch_overhead.py [--root DIR]`` (``DIR``: another
checkout whose ``zhusuan_tpu_torch`` to time, for example an earlier commit
unpacked with ``git archive`` into a git-ignored directory; by default this
one). For each entry below it takes
the host clock around ``CALLS`` un-synchronised calls on a tiny shape (so
the device never holds the host back), then synchronises once, and prints
the median over ``ROUNDS`` rounds of microseconds per call:

- ``gpu_normal`` and ``cholesky_inverse`` through ``ops/_launch.py``
  (``launch_kernel``), as the package calls them;
- the same two through the launch path the wrappers had before
  ``ops/_launch.py`` (rebuilt here as ``_launch_as_before``: the library
  and the entry looked up per call, a ``torch.cuda.device`` context, a
  ``Stream`` object for its ``cuda_stream``), so that before and after are
  read in one run on one card;
- ``fused_chees_step`` (one leapfrog) and ``fused_nuts_transition`` (depth
  1) on the same tiny shape, the wrappers the ChEES and NUTS samplers call
  once an iteration;
- ``torch.randn`` and ``torch.empty`` of the same tiny shape, PyTorch's own
  launch and allocation cost.

The last line is one JSON object with every figure, the card's name and its
power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CALLS = 1000
ROUNDS = 7
SHAPE = (1, 4)  # one group of 4 columns: one thread's work
N = 3  # the Cholesky size: one panel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout to time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("launch_overhead.py needs a CUDA device.")
    sys.path.insert(0, os.path.abspath(args.root))
    from zhusuan_tpu_torch.ops import (
        chees_step, linalg, nuts_step, random as zrandom,
    )
    from zhusuan_tpu_torch.ops.densities import (
        DiagonalGaussianLogJoint,
        EquicorrelatedGaussianLogJoint,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    key = (1, 2)
    a = torch.eye(N, device=dev) * 2.0
    q = torch.zeros(SHAPE, device=dev)
    ones = torch.ones((1, SHAPE[1]), device=dev)
    n_dev = torch.ones((), dtype=torch.int32, device=dev)
    equi = EquicorrelatedGaussianLogJoint("x", SHAPE[1], 0.5)
    diag = DiagonalGaussianLogJoint("x", torch.zeros(SHAPE[1], device=dev),
                                    torch.ones(SHAPE[1], device=dev))

    def _launch_as_before(kernel_library, entry, *args):
        lib, _ = kernel_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib, entry)(*args, stream)
        if rc != 0:
            raise RuntimeError("{} failed: {}".format(
                entry, lib.zs_cuda_error_string(rc).decode()))

    def normal_before():
        shape, k = zrandom._check("gpu_normal", key, SHAPE)
        device = zrandom._device(dev)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        _launch_as_before(zrandom.kernel_library, "zs_gpu_normal",
                          out.data_ptr(), shape[0], shape[1], *k)
        return out

    class _CholeskyBefore(torch.autograd.Function):
        @staticmethod
        def forward(ctx, m):
            m = m.contiguous()
            l, linv = torch.empty_like(m), torch.empty_like(m)
            _launch_as_before(linalg.kernel_library, "zs_cholesky_inverse",
                              m.data_ptr(), m.shape[0], l.data_ptr(),
                              linv.data_ptr(), 0)
            ctx.save_for_backward(l, linv)
            return l, linv

    entries = {
        "gpu_normal": lambda: zrandom.gpu_normal(key, SHAPE, dev),
        "gpu_normal_before": normal_before,
        "gpu_uniform": lambda: zrandom.gpu_uniform(key, SHAPE, dev),
        "cholesky_inverse": lambda: linalg.cholesky_inverse(a),
        "cholesky_inverse_before": lambda: _CholeskyBefore.apply(a),
        "fused_chees_step": lambda: chees_step.fused_chees_step(
            equi, q, ones, 0.1, n_dev, key, 1),
        "fused_nuts_transition": lambda: nuts_step.fused_nuts_transition(
            diag, q, ones, 0.1, 1, 1000.0, key, 1),
        "torch_randn": lambda: torch.randn(SHAPE, device=dev),
        "torch_rand": lambda: torch.rand(SHAPE, device=dev),
        "torch_empty": lambda: torch.empty(SHAPE, device=dev),
    }
    # Rounds outside, entries inside: every entry sees the same host states.
    rounds = {name: [] for name in entries}
    for fn in entries.values():
        for _ in range(200):
            fn()
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for name, fn in entries.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            rounds[name].append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
    out = {}
    for name, us in rounds.items():
        out[name] = {"host_us_per_call": statistics.median(us),
                     "min": min(us), "max": max(us)}
        print("{:28s} {:8.3f} us per call (min {:.3f}, max {:.3f})".format(
            name, out[name]["host_us_per_call"], min(us), max(us)),
            flush=True)
    print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      "torch": torch.__version__,
                      "calls": CALLS, "rounds": ROUNDS, "shape": list(SHAPE),
                      "cholesky_n": N, "host_us_per_call": out}))


if __name__ == "__main__":
    main()
