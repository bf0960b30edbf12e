"""Nothing the benchmark or its reference imports is JAX or the JAX
package, and the reference imports nothing of the program. Names are
compared by their top-level part whole, so ``zhusuan_tpu_torch`` is not
``zhusuan_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "zhusuan_tpu"}


def _files(sub=""):
    top = os.path.join(harness.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, harness.BENCH_DIR))
def test_no_jax_in_the_benchmark(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert not names & (FORBIDDEN | {"zhusuan_tpu_torch"})


def test_top_level_names_compare_whole():
    found = {m.split(".")[0] for m in ("zhusuan_tpu_torch.ops", "jaxtyping")}
    assert not found & FORBIDDEN
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "zhusuan_tpu")


def test_loaded_modules_after_importing_everything():
    """Import the harness, every driver, reference, target (both sides),
    metric and roofline and the program's samplers in a fresh process: no
    forbidden module is loaded, and the references load nothing of the
    program."""
    code = """
import sys
from benchmark import harness, tracing
mods = []
for kind in ("reference", "reference/targets", "roofline", "metrics"):
    for n in harness.names(kind, ".py"):
        harness.module(kind, n)
top = {m.split(".")[0] for m in sys.modules}
assert "zhusuan_tpu_torch" not in top, "a reference loaded the program"
for kind in ("samplers", "targets"):
    for n in harness.names(kind, ".py"):
        harness.module(kind, n)
import zhusuan_tpu_torch, zhusuan_tpu_torch.diagnostics
print(harness.forbidden_modules())
"""
    root = os.path.dirname(harness.BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
