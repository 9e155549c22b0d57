#!/usr/bin/env python3
"""Times the port's CUDA DP kernels of this checkout against those of
another checkout (the parent commit, unpacked with `git archive`) on one
NVIDIA GPU, in turns within one process, after holding their outputs
bit-equal on the same inputs.

  python3 scripts/torch_kernel_ab.py --base DIR [--rounds N] [--seed N]

Both checkouts' csrc/band_dp.cu and csrc/band_scores.cu are built by nvcc
for sm_90a (one process each, in parallel) and called through their C
entries: lrm_band_dp (the warp kernel, at the four bands of
chip_smoke.SHAPES), the wide kernel's entry (the 10 kb resident pass and
one 512-row gact tile at the 50 kb bands 5120 and 10112: lrm_band_dp_tiles
with one tile, or lrm_band_dp_wide in a checkout older than the multi-tile
entry) and lrm_band_scores (the checkpoints of the gact forward pass: an
8192-row pass at one CTA a read on both sides, then that pass and a 50 kb
pass at ops/band_scores.cluster_ctas's cluster size on a side that has
clusters, against one CTA a read on a side that has not), and, where both
checkouts have it, lrm_band_dp_tiles with a group of 39 tiles at band
5120 and of 20 at band 10112, as a 50 kb walk launches them.  Each round
calls base, new, new, base at every shape and times each call with CUDA
events; the JSON printed last holds the medians, the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, I = ctypes.c_void_p, ctypes.c_int
FUNCS = {"band_dp": {"lrm_band_dp": [P, P, I, I, I, I, P, P, P, P],
                     "lrm_band_dp_wide": [P, P, P, I, I, I, I, I, I, P, P, P,
                                          P],
                     "lrm_band_dp_tiles": [P, P, P, I, I, I, I, I, I, I, P, P,
                                           P, P]},
         "band_scores": {"lrm_band_scores": [P, P, I, I, I, I, I, P, P, P,
                                             P]}}
# lrm_band_scores of a checkout with clusters (it has lrm_band_scores_clusters)
SCORES_CLUSTER = [P, P, I, I, I, I, I, I, I, P, P, P, P]


def build(csrc: str, out: str) -> dict:
    """nvcc each source of `csrc` into `out`; {name: ctypes.CDLL}."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in FUNCS:
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", lib,
             os.path.join(csrc, f"{name}.cu")], stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {csrc}/{name}.cu failed:\n{err}")
        libs[name] = ctypes.CDLL(lib)
        for fn, argtypes in FUNCS[name].items():
            if not hasattr(libs[name], fn):   # an older checkout
                continue
            getattr(libs[name], fn).restype = ctypes.c_int
            getattr(libs[name], fn).argtypes = argtypes
    if hasattr(libs["band_scores"], "lrm_band_scores_clusters"):
        libs["band_scores"].lrm_band_scores.argtypes = SCORES_CLUSTER
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True,
                    help="root of the checkout to compare against")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab.py needs an NVIDIA GPU")
    from chip_smoke import dp_inputs
    from chip_smoke import PASS_SHAPES, SHAPES
    from longreadmapper_tpu_torch.ops.band_scores import (band_checkpoints,
                                                          cluster_ctas)
    from longreadmapper_tpu_torch.ops.wavefront import row0

    csrc = "longreadmapper_tpu_torch/csrc"
    with tempfile.TemporaryDirectory(prefix="lrm_ab_") as tmp:
        libs = {"base": build(os.path.join(args.base, csrc),
                              os.path.join(tmp, "base")),
                "new": build(os.path.join(HERE, csrc),
                             os.path.join(tmp, "new"))}
    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}

    def dirs_case(name, B, L, W, band, h0=None, i0=0, n=None, warp=False,
                  qt=None):
        q, t = dp_inputs(rng, B, L) if qt is None else qt
        n = L if n is None else n
        h0 = row0(B, L, W, band, q.device) if h0 is None else h0

        def run(side, q=q, t=t, h0=h0):
            G = n // 16
            out = (torch.empty((G, B, band), dtype=torch.int32, device="cuda"),
                   torch.empty((n + 1, B), dtype=torch.int16, device="cuda"),
                   torch.empty((-(-G // 32), B, band), dtype=torch.int32,
                               device="cuda"))
            lib = libs[side]["band_dp"]
            ptrs = [o.data_ptr() for o in out] + [stream]
            args = (q.data_ptr(), t.data_ptr(), h0.data_ptr(), B, L, W, band,
                    i0, n)
            if warp:
                err = lib.lrm_band_dp(q.data_ptr(), t.data_ptr(), B, L, W,
                                      band, *ptrs)
            elif hasattr(lib, "lrm_band_dp_tiles"):   # one tile of n rows
                err = lib.lrm_band_dp_tiles(*args, 1, *ptrs)
            else:
                err = lib.lrm_band_dp_wide(*args, *ptrs)
            if err:
                raise RuntimeError(f"{side} {name}: launch error {err}")
            return out
        cases[name] = run

    def tiles_case(name, B, L, W, band, tiles, T=512):
        """One launch of the newest `tiles` gact tiles of T rows of an L-row
        pass, entered in place from its checkpoint rows, as the walk
        launches its first group."""
        q, t = dp_inputs(rng, B, L)
        ckpt, _ = band_checkpoints(q, t, T, W, band)
        k0 = L // T - tiles

        def run(side, q=q, t=t):
            G = T // 16
            out = (torch.empty((tiles, G, B, band), dtype=torch.int32,
                               device="cuda"),
                   torch.empty((tiles, T + 1, B), dtype=torch.int16,
                               device="cuda"),
                   torch.empty((tiles, -(-G // 32), B, band),
                               dtype=torch.int32, device="cuda"))
            err = libs[side]["band_dp"].lrm_band_dp_tiles(
                q.data_ptr(), t.data_ptr(), ckpt[k0].data_ptr(), B, L, W,
                band, k0 * T, T, tiles, *[o.data_ptr() for o in out], stream)
            if err:
                raise RuntimeError(f"{side} {name}: launch error {err}")
            return out
        cases[name] = run

    def scores_case(name, B, L, W, band, T, ctas=1):
        """The checkpoints at `ctas` CTAs a read on a side with clusters,
        at one CTA a read on a side without."""
        q, t = dp_inputs(rng, B, L)

        def run(side, q=q, t=t):
            ck = torch.empty((L // T + 1, B, band), dtype=torch.int32,
                             device="cuda")
            wc = torch.empty((L + 1, B), dtype=torch.int16, device="cuda")
            lib = libs[side]["band_scores"]
            shape = ((B, L, W, band, T, ctas, 0)
                     if hasattr(lib, "lrm_band_scores_clusters")
                     else (B, L, W, band, T))
            err = lib.lrm_band_scores(q.data_ptr(), t.data_ptr(), *shape,
                                      None, ck.data_ptr(), wc.data_ptr(),
                                      stream)
            if err:
                raise RuntimeError(f"{side} {name}: launch error {err}")
            return ck, wc
        cases[name] = run

    for B, L, W, band in SHAPES:
        dirs_case(f"band_dp {B},{L},{band}", B, L, W, band, warp=True)
    dirs_case("resident 10 kb", 200, 10240, 512, 1152)
    for W, band in ((2508, 5120), (5017, 10112)):
        q, t = dp_inputs(rng, 40, 8192)
        ckpt, _ = band_checkpoints(q, t, 512, W, band)
        dirs_case(f"tile {band}", 40, 8192, W, band,
                  h0=ckpt[8].contiguous(), i0=8 * 512, n=512, qt=(q, t))
    scores_case("checkpoints 8192 C1 (control)", 40, 8192, 2508, 5120, 512)
    C = cluster_ctas(40, 5120)
    scores_case(f"checkpoints 8192 C{C}", 40, 8192, 2508, 5120, 512, C)
    B, L, W, band = PASS_SHAPES[0]
    C = cluster_ctas(B, band)
    scores_case(f"checkpoints 50 kb pass C{C}", B, L, W, band, 512, C)
    if all(hasattr(lib["band_dp"], "lrm_band_dp_tiles")
           for lib in libs.values()):
        tiles_case("tiles 5120 x39", 40, 50176, 2508, 5120, 39)
        tiles_case("tiles 10112 x20", 40, 50176, 5017, 10112, 20)

    for name, run in cases.items():
        a, b = run("base"), run("new")
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: base and new outputs differ")
        print(f"[ab] {name}: base and new bit-equal", flush=True)
    times = {name: {"base": [], "new": []} for name in cases}
    for r in range(args.rounds):
        for name, run in cases.items():
            for side in ("base", "new", "new", "base"):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run(side)
                b.record()
                b.synchronize()
                times[name][side].append(a.elapsed_time(b))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    med = {name: {side: statistics.median(v) for side, v in t.items()}
           for name, t in times.items()}
    for name, m in med.items():
        print(f"[ab] {name}: base {m['base']} ms, new {m['new']} ms "
              f"({m['new'] / m['base']:.4f}x)", flush=True)
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "calls_per_side": 2 * args.rounds, "median_ms": med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
