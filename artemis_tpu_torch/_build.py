"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, written to ``artemis_tpu_torch/_build/`` (not
committed) under a name carrying a hash of the source and flags, so an
edited source rebuilds and an unchanged one loads the earlier build.  The
library is opened with ctypes.  A failed build raises; nothing prebuilt is
used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
# name -> (seconds, nvcc output) of the builds made by this process
build_log: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>.cu``, compiling it first
    when no build of this source and these flags exists."""
    so = _library_path(name)
    if so in _loaded:
        return _loaded[so]
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}.cu "
                               f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        build_log[name] = (time.perf_counter() - t0, res.stdout + res.stderr)
    _loaded[so] = ctypes.CDLL(str(so))
    return _loaded[so]
