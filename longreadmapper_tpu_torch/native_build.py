"""Build and load the port's native code: the hand-written CUDA kernels (the
banded DPs, the CIGAR walks, the seed vote and the step's glue) and the host code of the
index build and the aligners (the suffix-array build, the external
build's merge, the affine traceback, the banded unit-cost aligner and the
Myers edit distance).

Each source of `SOURCES` in `csrc/` is compiled by its compiler (nvcc for
sm_90a for the kernels, g++ for the host code) into a shared library with
a plain C interface, `longreadmapper_tpu_torch/_build/lib<name>.so`
(git-ignored), at first use, and loaded with ctypes.  `build()` starts one
compiler per stale source, all at once, and waits for them;
`build_info[name]` keeps the compiler, the seconds and its report (for
nvcc, `-Xptxas -v`: registers, stack, spills per kernel).  A failed build
raises with the compiler's message; nothing falls back to another
implementation.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}


def _nvcc(src: str, out: str) -> list:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return [cand, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-I", CSRC, "-o", out, src]
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "in longreadmapper_tpu_torch/csrc cannot be built")


def _gxx(src: str, out: str) -> list:
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", out, src]


# name -> (source in csrc/, its compiler command, the headers it includes)
SOURCES = {
    "band_dp": ("band_dp.cu", _nvcc, "*.cuh"),
    "band_scores": ("band_scores.cu", _nvcc, "*.cuh"),
    "walk": ("walk.cu", _nvcc, "*.cuh"),
    "vote": ("vote.cu", _nvcc, None),
    "step": ("step.cu", _nvcc, None),
    "sais": ("sais.cpp", _gxx, None),
    "samerge": ("samerge.cpp", _gxx, None),
    "affine": ("affine.cpp", _gxx, None),
    "align": ("align.cpp", _gxx, None),
    "myers": ("myers.cpp", _gxx, None),
}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def source(name: str) -> str:
    return os.path.join(CSRC, SOURCES[name][0])


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    headers = SOURCES[name][2]
    deps = [source(name)] + (glob.glob(os.path.join(CSRC, headers))
                             if headers else [])
    return any(os.path.getmtime(p) > os.path.getmtime(lib) for p in deps)


def build(names=tuple(SOURCES), force: bool = False) -> None:
    """Compile the named sources that are missing or older than their
    sources (all of them with `force`), one compiler each, in parallel.
    Raises on a failed build, with the compiler's message."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = SOURCES[name][1](source(name), tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {cmd[0]} to build "
                               f"{source(name)}: {e}") from e
        procs[name] = (proc, os.path.basename(cmd[0]), tmp,
                       time.perf_counter())
    failed = []
    for name, (proc, tool, tmp, t0) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name][0]}: {tool} exit "
                          f"{proc.returncode}\n{err}")
            continue
        os.replace(tmp, lib_path(name))
        build_info[name] = dict(tool=tool, seconds=time.perf_counter() - t0,
                                report=err.strip())
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))


def load(name: str, functions: dict) -> ctypes.CDLL:
    """The library of SOURCES[name], built if stale, with each C function
    of `functions` typed: {name: argtypes} returns int, {name: (argtypes,
    restype)} returns restype (a 64-bit count needs ctypes.c_int64)."""
    with _lock:
        if name not in _libs:
            build(names=(name,))
            lib = ctypes.CDLL(lib_path(name))
            for fn, spec in functions.items():
                argtypes, restype = (spec if isinstance(spec, tuple)
                                     else (spec, ctypes.c_int))
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]
