"""Run one cell of the benchmark of ``zhusuan_tpu_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints one JSON line on standard output
(``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer
metrics, the device's busy time and a breakdown), after the numbers the
check compared, each beside its limit, on standard error. Exits non-zero,
printing no result, where there is no CUDA card, where a module of JAX or
of the JAX package is loaded, or where the program cannot be imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA libraries into its own ``_build/``)."""
    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    _cache_dirs()
    sys.path[0] = ROOT  # the checkout's root, not benchmark/
    from benchmark import harness

    age = harness.process_age() - (time.perf_counter() - T_START)
    try:
        return harness.main(args, T_START, age)
    except (harness.Refused, ImportError) as err:
        print("refused: {}".format(err), file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
