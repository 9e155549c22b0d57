"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` (with the shared headers `csrc/*.cuh`) is
compiled by nvcc for sm_90a into a shared library with a plain C interface,
`longreadmapper_tpu_torch/_build/lib<name>.so` (git-ignored), at first use,
and loaded with ctypes.  `build()` starts one nvcc per stale source, all at
once, and waits for them; `build_info[name]` keeps the seconds and nvcc's
`-Xptxas -v` report (registers, stack, spills per kernel).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("band_dp", "band_scores")

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "in longreadmapper_tpu_torch/csrc cannot be built")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(
        os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > os.path.getmtime(lib) for p in deps)


def build(names=SOURCES, force: bool = False) -> None:
    """Compile the named sources that are missing or older than their
    sources (all of them with `force`), one nvcc each, in parallel.
    Raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exit {proc.returncode}\n{err}")
            continue
        os.replace(tmp, lib_path(name))
        build_info[name] = dict(seconds=time.perf_counter() - t0,
                                ptxas=err.strip())
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str, functions: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if stale, with each C function
    of `functions` ({name: argtypes}) typed to return int."""
    with _lock:
        if name not in _libs:
            build(names=(name,))
            lib = ctypes.CDLL(lib_path(name))
            for fn, argtypes in functions.items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]
