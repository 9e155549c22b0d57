#!/usr/bin/env python3
"""Where walk_c_kernel's loop spends its cycles, on one NVIDIA GPU: the
checkout's csrc/walk.cu with clock64 reads added around the three parts
of an iteration (the wait for the ring's copies, resident_step, issuing the
next column's copies), summed over every lane, and a count of the groups
read from device memory below a slot's window; built by nvcc with
native_build's flags and run in place of the checkout's own library on
chip_smoke.py phase 3's resident passes, 1 kb (MAIN_SHAPE) and 10 kb
(WIDE_MAIN), its runs held equal to the plain walk's.

  python3 scripts/torch_walk_c_split.py [NAME=VALUE ...]

Each NAME=VALUE rewrites a design constant of walk.cu (kWalkGroups=56,
for example).  One JSON line a shape: cycles an iteration of the lanes'
loops (wait, step, load, and the rest of each iteration), fallbacks an
iteration; then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (anchor in walk.cu, its instrumented text)
PROBES = (
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_split[6];\n"),
    ("    return g >= G ? tail : (g >= lo ? win[g - lo] : "
     "__ldg(v + g * plane + at));",
     "    if (g < G && g < lo && (threadIdx.x & 31) == 0) "
     "atomicAdd(&g_split[3], 1ull);\n"
     "    return g >= G ? tail : (g >= lo ? win[g - lo] : "
     "__ldg(v + g * plane + at));"),
    ("  int n = 0;\n  while (n < n_iter && !done) {\n"
     "    const bool in_tile = i > 0;\n    if (in_tile) {\n"
     "      cp_wait<kWalkAhead>();",
     "  int n = 0;\n  long long tw = 0, ts = 0, tl = 0, t1 = 0;\n"
     "  const long long tb = clock64();\n"
     "  while (n < n_iter && !done) {\n"
     "    const bool in_tile = i > 0;\n    if (in_tile) {\n"
     "      const long long t0 = clock64();\n"
     "      cp_wait<kWalkAhead>();"),
    ("      retired = committed - kWalkAhead;\n",
     "      retired = committed - kWalkAhead;\n"
     "      t1 = clock64();\n      tw += t1 - t0;\n"),
    ("        WindowColumn{win, win + K, lo, G, tail, vdirs, plane, at + d}, "
     "nbm, i,\n        j);\n",
     "        WindowColumn{win, win + K, lo, G, tail, vdirs, plane, at + d}, "
     "nbm, i,\n        j);\n"
     "    asm volatile(\"\" ::\"r\"(s.i), \"r\"(s.j), \"r\"(s.e1), "
     "\"r\"(s.e2));\n"
     "    const long long ta = clock64();\n"
     "    if (in_tile) ts += ta - t1;\n"),
    ("      ++committed;\n      d = d2;\n    }\n  }\n",
     "      ++committed;\n      d = d2;\n      tl += clock64() - ta;\n"
     "    }\n  }\n"
     "  if (lane == 0) {\n"
     "    atomicAdd(&g_split[0], static_cast<unsigned long long>(tw));\n"
     "    atomicAdd(&g_split[1], "
     "static_cast<unsigned long long>(clock64() - tb));\n"
     "    atomicAdd(&g_split[2], static_cast<unsigned long long>(n));\n"
     "    atomicAdd(&g_split[4], static_cast<unsigned long long>(ts));\n"
     "    atomicAdd(&g_split[5], static_cast<unsigned long long>(tl));\n"
     "  }\n"),
    ('extern "C" int lrm_walk_c_lanes(',
     'extern "C" int lrm_walk_split(unsigned long long* out, int reset) {\n'
     "  if (reset) {\n    unsigned long long z[6] = {0};\n"
     "    return cudaMemcpyToSymbol(g_split, z, sizeof(z));\n  }\n"
     "  return cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));\n}\n\n"
     'extern "C" int lrm_walk_c_lanes('),
)


def instrumented(src: str) -> str:
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise AssertionError(f"walk.cu: {src.count(anchor)} places for "
                                 f"the probe at {anchor[:50]!r}")
        src = src.replace(anchor, text)
    return src


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    consts = dict(a.split("=", 1) for a in argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import numpy as np
    import torch
    import chip_smoke as smoke
    from longreadmapper_tpu_torch.ops import traceback as ttb
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    from torch_walk_tables_sweep import build_variants, load, using
    if not torch.cuda.is_available():
        raise SystemExit("torch_walk_c_split.py needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    funcs = dict(ttb.WALK_FUNCS,
                 lrm_walk_split=[ctypes.c_void_p, ctypes.c_int])
    with tempfile.TemporaryDirectory(prefix="lrm_split_") as d:
        lib = load(build_variants(d, {"split": ("walk", consts)},
                                  instrumented)["split"], funcs)
    with using("walk", lib):
        rng = np.random.default_rng(0)
        for name, (B, L, W, band), indel in (
                ("1kb", smoke.MAIN_SHAPE, 0.0),
                ("10kb", smoke.WIDE_MAIN, smoke.WALK_INDEL)):
            dt = torch.int16 if max(L, band - W) < 8192 else torch.int32
            q, t = smoke.dp_inputs(rng, B, L, indel)
            v, wcol, nm = banded_nw_dirs(q, t, W, band)
            lens = smoke.walk_lens(q, wcol, W)
            ttb.device_traceback_c(v, lens, L, W, nm, dt)   # warm-up
            torch.cuda.synchronize()
            lib.lrm_walk_split(None, 1)
            got = ttb.device_traceback_c(v, lens, L, W, nm, dt)
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * 6)()
            lib.lrm_walk_split(ctypes.addressof(out), 0)
            wait, total, iters, below, step, issue = list(out)
            want = ttb.device_traceback_c_plain(v, lens, L, W, nm, dt)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: runs differ from the plain "
                                     "walk's")
            print(json.dumps(dict(
                shape=name, consts=consts, iterations=iters,
                wait_cycles=wait / iters, step_cycles=step / iters,
                load_cycles=issue / iters,
                rest_cycles=(total - wait - step - issue) / iters,
                fallbacks=below / iters)), flush=True)
            del v, nm, wcol
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
