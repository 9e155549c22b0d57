#!/usr/bin/env python3
"""A short card check of the port's multi-device path: chip_smoke.py's
phase 10 (`cli mapdist` at world 1, replicated and `--shard-index`, 200
10 kb reads through the mesh's full-band gact, the seed vote over
ShardedRows, `cli warmup` before a fresh `cli map`) on a smaller set than
the smoke's: a 1 Mb genome, 4096 1 kb reads and 200 10 kb reads, all
made from --seed.  About 75 s on one NVIDIA H100 (the kernels' build
included); it raises on any failed check, and its last line is PROBE_OK
with the seconds.

  python3 scripts/torch_dist_probe.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as smoke
    from longreadmapper_tpu_torch import cli
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{smoke.phase_device()}", flush=True)
    t0 = time.perf_counter()
    n1, n10 = 4096, smoke.N_DIST_LONG
    with tempfile.TemporaryDirectory(prefix="lrm_probe_") as d:
        fa, fq, pos, g = smoke.make_data(d, args.seed, 1_000_000, n1, 1000,
                                         0.03)
        with open(os.path.join(d, "index.log"), "w") as e, \
                contextlib.redirect_stderr(e):
            cli.main(["index", fa])
        smoke.map_cli(fa, fq, n1, "cuda", os.path.join(d, "out.sam"),
                      os.path.join(d, "map.log"))
        reads, lpos, _ = smoke.make_long_reads(g, args.seed + 1, n10, 10000)
        smoke.write_fastq(os.path.join(d, "10kb.fq"), reads)
        smoke.map_cli(fa, os.path.join(d, "10kb.fq"), n10, "cuda",
                      os.path.join(d, "10kb.sam"),
                      os.path.join(d, "10kb.log"), 2048)
        stage_reads = next(iter(load_read_batches(fq, n1,
                                                  background=False)))
        smoke.phase_dist(d, fa, fq, n1, pos, g, (reads, lpos), stage_reads)
    print(f"PROBE_OK {time.perf_counter() - t0}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
