"""``run.py`` prints no result where it cannot measure the card."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ROOT = os.path.dirname(harness.BENCH_DIR)


def _run(*extra, cwd=ROOT):
    return subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", "nuts.neal100d.4k", "--seed", str(2 ** 40 + 1),
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run()
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """A one-second window of the smallest cell on the card, checked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    out = _run()
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "check"
