"""Measure the PyTorch port's throughput and accuracy on the acceptance
configurations, at the full recipes of ``baseline_ref/configs_protocol.py``
and ``baseline_ref/vae_protocol.py`` (copied in
``zhusuan_tpu_torch/examples/utils/protocols.py``): the torch counterpart of
``baseline_ref/measure_configs_ours.py``.

Configurations: ``toy2d`` (50 + 16000 steps), ``bnn_sgvb`` and
``bnn_sghmc`` (50 + 8000), ``sbn_vimco`` (30 + 2000), ``svgp`` (30 + 600,
the kernel path: ``chip_smoke.py``'s phase-15 run), ``vae_protocol`` (20
epochs of 78 steps) and ``svgp_diabetes`` (the SVGP example's ``main
-dataset diabetes`` for 2000 epochs, whose last line gives the test RMSE
and log-likelihood; without scikit-learn it needs a ``diabetes.npz`` under
``ZS_DATA_DIR``, see ``examples/utils/dataset.py::save_uci_diabetes``).
Each step is one Python-loop iteration of the example's own train step;
steps/s is timed steps over their wall seconds, the device synchronized at
both ends.

Run on the card from the repository root::

    python3 scripts/measure_configs_torch.py [--commit ID] [--trials N] \\
        [config ...]

Writes (merging by configuration) ``scripts/torch_configs.json``, each
entry stamped with ``--commit`` (default: ``git rev-parse HEAD`` where git
can tell) and the card's name and power limit as ``nvidia-smi`` reports
them.
"""

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from zhusuan_tpu_torch.examples import acceptance  # noqa: E402
from zhusuan_tpu_torch.examples.gaussian_process import svgp  # noqa: E402

OUT = os.path.join(ROOT, "scripts", "torch_configs.json")
DIABETES_EPOCHS = 2000


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return out


def _commit(given):
    if given:
        return given
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown (no git here: pass --commit)"


def measure_svgp_diabetes(device, n_epoch=DIABETES_EPOCHS):
    """``svgp.main -dataset diabetes -n_epoch 2000`` on ``device``; its
    printed lines are kept, the last gives the test RMSE and
    log-likelihood (y in its original units)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        svgp.main(["-dataset", "diabetes", "-n_epoch", str(n_epoch),
                   "--device", str(device)])
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    last = re.search(r"test rmse = ([-\d.]+), test ll = ([-\d.]+)",
                     lines[-1])
    return {"epochs": n_epoch, "wall_sec": seconds,
            "epochs_per_sec": n_epoch / seconds,
            "test_rmse": float(last.group(1)),
            "test_ll": float(last.group(2)), "log": lines}


def measure(name, device, trials):
    """One configuration: ``trials`` runs from the start; the entry keeps
    the median steps/s and every run's numbers."""
    if name == "svgp_diabetes":
        return measure_svgp_diabetes(device)
    if name == "vae_protocol":
        runs = [acceptance.run_vae_protocol(device, seed=1 + t)[1]
                for t in range(trials)]
    elif name == "svgp":  # chip_smoke.py phase 15's run, kernel path
        cfg = svgp.SVGP_CONFIG
        runs = [dict(chip_smoke._svgp_run(torch, device, True, seed=t),
                     warmup_steps=cfg["warmup_steps"],
                     timed_steps=cfg["timed_steps"])
                for t in range(trials)]
    else:
        runs = [acceptance.run(name, device) for _ in range(trials)]
    for run in runs:
        if not run["finite"]:
            raise SystemExit("{}: a non-finite metric".format(name))
    entry = dict(runs[0]) if trials == 1 else {"runs": runs}
    entry["steps_per_sec"] = statistics.median(
        r["steps_per_sec"] for r in runs)
    return entry


CONFIGS = ("toy2d", "bnn_sgvb", "bnn_sghmc", "sbn_vimco", "svgp",
           "vae_protocol", "svgp_diabetes")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("configs", nargs="*", metavar="config",
                        help="any of {} (default: all)".format(
                            ", ".join(CONFIGS)))
    parser.add_argument("--commit", default=None,
                        help="the commit (or tree) measured, for the stamp")
    parser.add_argument("--trials", default=1, type=int)
    args = parser.parse_args(argv)
    unknown = set(args.configs) - set(CONFIGS)
    if unknown:
        parser.error("unknown configurations: {}".format(sorted(unknown)))
    if not torch.cuda.is_available():
        raise SystemExit("No CUDA device: this script measures the card.")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    stamp = {"commit": _commit(args.commit), "card": _card(),
             "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(stamp), flush=True)
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    for name in args.configs or CONFIGS:
        t0 = time.perf_counter()
        entry = measure(name, device, args.trials)
        entry.update(stamp)
        entry["what"] = ("zhusuan_tpu_torch, the example's train step in a "
                         "Python loop, median of {} run(s)".format(
                             args.trials))
        entry["seconds"] = time.perf_counter() - t0
        results[name] = entry
        print(name, json.dumps({k: v for k, v in entry.items()
                                if k not in ("log", "elbo_curve",
                                             "epoch_sec", "runs")}),
              flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
