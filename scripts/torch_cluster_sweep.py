#!/usr/bin/env python3
"""Measures the launch shapes of the port's CUDA kernels on one NVIDIA GPU,
for the choices the port makes from the shape alone:

  * band_scores (csrc/band_scores.cu) at each gact pass of the main path
    (chip_smoke.PASS_SHAPES), and at passes of 39 and 30 reads, split over
    C = 1 .. 4 CTAs a read, at each K (columns a thread) the kernel takes
    for that C, every variant held
    bit-equal to the C = 1 launch and all timed in turns; with the clusters
    the card holds at once (cudaOccupancyMaxActiveClusters) and the choice
    of ops/band_scores.cluster_ctas;
  * the cost of a row's meeting alone, in a loop that does nothing else
    (lrm_meet_probe), per row: the slot store and __syncthreads (C = 1),
    DSMEM stores and the cluster barrier, and the cluster row's own
    meeting (st.async into every CTA, the row's mbarrier);
  * band_dp (the warp per read) against band_dp_wide (one tile from row 0)
    at the bands 128-512 of chip_smoke.SHAPES, in turns, which set
    ops/band_dp.BANDS.

  python3 scripts/torch_cluster_sweep.py [--rounds N] [--seed N]

The JSON printed last holds every median (ms), the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_ROWS = 20000
EXTRA_SHAPES = ((39, 50176, 2508, 5120), (39, 50176, 5017, 10112),
                (30, 50176, 2508, 5120), (39, 10240, 1024, 2176))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_cluster_sweep.py needs an NVIDIA GPU")
    from chip_smoke import (PASS_SHAPES, SHAPES, TILE_T, ckpt_bound,
                            dirs_bound, dp_inputs, turns)
    from longreadmapper_tpu_torch import native_build
    from longreadmapper_tpu_torch.ops import band_scores as bs
    from longreadmapper_tpu_torch.ops.band_dp import _band_dp, band_dp_tiles
    from longreadmapper_tpu_torch.ops.wavefront import row0

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[sweep] {card}", flush=True)
    native_build.build(names=("band_dp", "band_scores"))
    lib = native_build.load("band_scores", bs._FUNCS)
    resident = bs.card_resident(0)
    rng = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    T = TILE_T
    out = {"card": card, "resident": resident, "rounds": args.rounds}
    print(f"[sweep] clusters held at once, one CTA an SM: {resident}",
          flush=True)

    # band_scores over C and K at the three gact passes
    fns, info = {}, {}
    # the passes, and passes of as many reads as the card holds clusters of
    # 3 (39) and of 4 (30) at once with one CTA an SM, so that every C runs
    # in one wave somewhere
    for B, L, W, band in PASS_SHAPES + EXTRA_SHAPES:
        q, t = dp_inputs(rng, B, L)
        bnd = ckpt_bound(B, L, band, T)
        ref = None
        for C in range(1, bs.MAX_CTAS + 1):
            for K in ((0,) if C == 1 else (4, 8, 16)):
                def run(q=q, t=t, B=B, L=L, W=W, band=band, C=C, K=K):
                    ck = torch.empty((L // T + 1, B, band), dtype=torch.int32,
                                     device="cuda")
                    wc = torch.empty((L + 1, B), dtype=torch.int16,
                                     device="cuda")
                    err = lib.lrm_band_scores(q.data_ptr(), t.data_ptr(), B,
                                              L, W, band, T, C, K, None,
                                              ck.data_ptr(), wc.data_ptr(),
                                              stream)
                    return err, (ck, wc)
                err, got = run()
                if err == -1:          # a (C, K) the kernel does not take
                    continue
                if err:
                    raise RuntimeError(f"band_scores {B, L, W, band} C={C} "
                                       f"K={K}: launch error {err}")
                torch.cuda.synchronize()
                if ref is None:
                    ref = got
                elif not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"band_scores {B, L, W, band} C={C} "
                                         f"K={K} differs from C=1")
                name = f"scores {B},{L},{band} C{C} K{K or 'default'}"
                fns[name] = lambda run=run: run()
                info[name] = dict(bound_ms=bnd[0], clusters=(
                    lib.lrm_band_scores_clusters(B, band, C, K)
                    if C > 1 else None))
        print(f"[sweep] band_scores {B, L, W, band}: every (C, K) bit-equal "
              f"to C=1; cluster_ctas -> {bs.cluster_ctas(B, band, resident)}",
              flush=True)
        out.setdefault("cluster_ctas", {})[f"{B},{L},{band}"] = \
            bs.cluster_ctas(B, band, resident)
    ms = turns(fns, args.rounds)
    out["band_scores"] = {k: dict(ms=ms[k], share=info[k]["bound_ms"] / ms[k],
                                  **info[k]) for k in fns}
    for k, v in out["band_scores"].items():
        print(f"[sweep] {k}: {v['ms']} ms, {v['share']:.4f} of the bound "
              f"{v['bound_ms']} ms, resident clusters {v['clusters']}",
              flush=True)
    del fns

    # the row's meeting alone, at the thread counts of the 50 kb pass
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    probes = {}
    shapes = [(1, 320, 0), (1, 448, 0)] + [
        (C, threads, mode) for mode in (1, 2)
        for C, threads in ((2, 640), (3, 448), (4, 320), (2, 320), (3, 224),
                           (2, 128), (3, 128), (4, 128))]
    modes = {0: "syncthreads", 1: "cluster barrier", 2: "mbarrier"}
    for C, threads, mode in shapes:
        def probe(C=C, threads=threads, mode=mode):
            err = lib.lrm_meet_probe(40, C, threads, PROBE_ROWS, mode,
                                     sink.data_ptr(), stream)
            if err:
                raise RuntimeError(f"meet probe C={C} mode {mode}: error "
                                   f"{err}")
        probes[f"{modes[mode]} C{C} x{threads}"] = probe
    pm = turns(probes, args.rounds)
    out["meet_ns_a_row"] = {k: v * 1e6 / PROBE_ROWS for k, v in pm.items()}
    print(f"[sweep] a row's meeting alone (ns, 40 clusters, {PROBE_ROWS} "
          f"rows): {json.dumps(out['meet_ns_a_row'])}", flush=True)

    # band_dp against band_dp_wide at the warp kernel's bands
    fns, bounds = {}, {}
    for B, L, W, band in SHAPES:
        q, t = dp_inputs(rng, B, L)
        h0 = row0(B, L, W, band, q.device)[None]
        warp = _band_dp(q, t, W, band)
        wide = [x[0] for x in band_dp_tiles(q, t, W, band, h0, L, 0, 1)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(warp, wide)):
            raise AssertionError(f"band_dp and band_dp_wide differ at "
                                 f"{B, L, W, band}")
        fns[f"band_dp {B},{L},{band}"] = (
            lambda q=q, t=t, W=W, band=band: _band_dp(q, t, W, band))
        fns[f"band_dp_wide {B},{L},{band}"] = (
            lambda q=q, t=t, W=W, band=band, h0=h0, L=L: band_dp_tiles(
                q, t, W, band, h0, L, 0, 1))
        bounds[f"{B},{L},{band}"] = dirs_bound(B, L, band, L)[0]
    ms = turns(fns, args.rounds)
    out["band_dp"] = {k: dict(ms=v, bound_ms=bounds[k.split(" ")[1]])
                      for k, v in ms.items()}
    for k, v in out["band_dp"].items():
        print(f"[sweep] {k}: {v['ms']} ms, {v['bound_ms'] / v['ms']:.4f} of "
              f"the bound {v['bound_ms']} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
