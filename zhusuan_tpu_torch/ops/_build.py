"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``zhusuan_tpu_torch/_build/`` (git-ignored),
under a file name keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the source's flags, and loaded with ``ctypes``. Nothing
here runs at import time. :func:`build_libraries` starts one ``nvcc`` per
source, all at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["build_libraries", "load_library", "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# -fmad=false: the kernels round every product and sum on their own, as
# the plain torch versions' separate elementwise ops do, so a trajectory
# over the diagonal Gaussian agrees bit for bit (an FMA would round once
# where torch rounds twice). Every source gets it but the ones listed here.
# linalg: held to a library factorization, which rounds differently anyway
# (tolerances, never bit for bit), and its rank-16 update is a matrix
# product whose rate is the FMA's. ess: held to the float64 estimator by
# tolerance, its sums of products are the kernel's arithmetic.
FMA_SOURCES = ("linalg", "ess")

_LOADED = {}  # name -> (ctypes.CDLL, build record)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH.")


def _paths(name: str):
    """``(source, flags, library path, log path)`` of ``csrc/<name>.cu``."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    flags = NVCC_FLAGS
    if name not in FMA_SOURCES:
        flags += ("-fmad=false",)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = "{}-{}".format(name, digest.hexdigest()[:16])
    return (src, flags, os.path.join(BUILD_DIR, stem + ".so"),
            os.path.join(BUILD_DIR, stem + ".log"))


def build_libraries(names):
    """Load ``csrc/<name>.cu`` for every name, compiling the missing ones
    in parallel (one ``nvcc`` each, all started together); returns
    ``{name: (cdll, record)}`` (see :func:`load_library`)."""
    requested = list(names)
    names = [n for n in requested if n not in _LOADED]
    jobs = {}
    for name in names:
        src, flags, lib_path, _ = _paths(name)
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "{}.{}.tmp".format(lib_path, os.getpid())
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, start) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        src, _, lib_path, log_path = _paths(name)
        if proc.returncode != 0:
            failures.append("nvcc failed to build {} (exit {}):\n{}".format(
                src, proc.returncode, log))
            continue
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        _, _, lib_path, log_path = _paths(name)
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        record = {"path": lib_path, "build_seconds": seconds.get(name, 0.0),
                  "log": log}
        _LOADED[name] = (ctypes.CDLL(lib_path), record)
    return {name: _LOADED[name] for name in requested}


def load_library(name: str):
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, load it
    and return ``(cdll, record)``; ``record`` holds ``path``,
    ``build_seconds`` (0.0 when already built) and the compiler's
    ``log`` (its ``-Xptxas -v`` register and spill report)."""
    if name not in _LOADED:
        build_libraries([name])
    return _LOADED[name]
