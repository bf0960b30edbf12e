"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``zhusuan_tpu_torch/_build/`` (git-ignored),
under a file name keyed by a hash of the source and the flags, and loaded
with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load_library", "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

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


def load_library(name: str):
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, load it
    and return ``(cdll, record)``; ``record`` holds ``path``,
    ``build_seconds`` (0.0 when already built) and the compiler's
    ``log`` (its ``-Xptxas -v`` register and spill report)."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = "{}-{}".format(name, digest.hexdigest()[:16])
    lib_path = os.path.join(BUILD_DIR, stem + ".so")
    log_path = os.path.join(BUILD_DIR, stem + ".log")
    seconds = 0.0
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "{}.{}.tmp".format(lib_path, os.getpid())
        start = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed to build {} (exit {}):\n{}".format(
                    src, proc.returncode, log))
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    record = {"path": lib_path, "build_seconds": seconds, "log": log}
    _LOADED[name] = (ctypes.CDLL(lib_path), record)
    return _LOADED[name]
