"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, written to ``artemis_tpu_torch/_build/`` (not
committed) under a name carrying a hash of the source, of every header it
includes from ``csrc/`` and of the flags, so an edited source or header
rebuilds and an unchanged one loads the earlier build.  The library is
opened with ctypes.  A failed build raises; nothing prebuilt is
used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source additions: each stage source holds separately compiled
# kernels of one stage (the curvilinear stage's halo variants; both
# stages' tiled and per-cell bodies), and fld.cu the two bodies of
# fld_coeffs; with multiply-add contraction each may fuse different
# products (the fusion depends on what else uses a product), so their
# results could part in the last bit (the Cartesian bodies did); without
# it they make the same IEEE operations and agree bitwise
SOURCE_FLAGS = {"stage_curv": ("-fmad=false",), "stage_cart": ("-fmad=false",),
                "fld": ("-fmad=false",)}

_loaded: dict = {}
# name -> (seconds, nvcc output) of the builds made by this process
build_log: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(path: Path, seen=None) -> list:
    """``path`` and, recursively, the ``csrc/`` headers it includes with
    ``#include "..."``, each once, in the order first met."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
        _sources(CSRC / inc, seen)
    return seen


def _library_path(name: str, flags) -> Path:
    h = hashlib.sha256("\0".join(flags).encode())
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def variant(name: str, defines=()) -> str:
    """The build's name in ``build_log``: the source, and its defines."""
    return " ".join([name, *defines])


def load(name: str, defines=()) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>.cu`` with the macro
    ``defines`` ("NAME=VALUE"), compiling it first when no build of these
    sources and flags exists."""
    key = (name, tuple(defines))
    if key in _loaded:
        return _loaded[key]
    flags = (*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), *(f"-D{d}" for d in defines))
    so = _library_path(name, flags)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{abs(hash(flags))}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}.cu {' '.join(defines)} "
                               f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        build_log[variant(name, defines)] = (time.perf_counter() - t0, res.stdout + res.stderr)
    # once loaded, a process keeps its library (no re-hash per launch)
    _loaded[key] = ctypes.CDLL(str(so))
    return _loaded[key]
