#!/usr/bin/env python3
"""`cli map` of this checkout against another checkout's (the parent
commit, unpacked with `git archive`) on one NVIDIA GPU, in turns within
one call: reads/s end to end and the mapper's `phase_s` split (prepare,
dispatch, fetch, assemble) of the 1 kb, 10 kb and 50 kb read sets of
chip_smoke.py on its 4 Mb genome, all made from --seed.

  python3 scripts/torch_walk_ab.py --base DIR [--seed N] [--rounds N]

The index is built once by this checkout (`cli index`, the lchash on the
card); both checkouts read the same artifacts and `.devidx` cache.  Each
checkout first builds its kernels (native_build.build, not timed); then
each round maps every set as base, new, new, base, each `cli map --device
cuda --chunk-b 2048` in a fresh process, and holds the two checkouts' SAM
byte-identical.  The JSON printed last holds each run's seconds, reads/s
and phase_s, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = {"1kb": (16384, 1000), "10kb": (800, 10_000), "50kb": (160, 50_000)}


def run_map(checkout: str, fa: str, fq: str, n: int, sam: str) -> dict:
    """One `cli map` of `checkout` in a fresh process; its wall seconds and
    the phase_s line of its verbose log."""
    env = dict(os.environ, PYTHONPATH=checkout)
    t0 = time.perf_counter()
    with open(sam, "w") as out:
        r = subprocess.run(
            [sys.executable, "-m", "longreadmapper_tpu_torch.cli", "map", fa,
             fq, str(n), "20", "300", "--chunk-b", "2048", "--rg-id", "0",
             "--device", "cuda"], stdout=out, stderr=subprocess.PIPE,
            text=True, cwd=checkout, env=env, timeout=900)
    s = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"cli map in {checkout} failed:\n"
                           + r.stderr[-3000:])
    phase = next(json.loads(l.split("phase_s ", 1)[1])
                 for l in r.stderr.splitlines() if "phase_s " in l)
    return dict(seconds=s, reads_s=n / s, phase_s=phase)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from longreadmapper_tpu_torch import cli

    card = smoke.phase_device()
    base = os.path.abspath(args.base)
    for checkout in (base, HERE):
        subprocess.run([sys.executable, "-c",
                        "from longreadmapper_tpu_torch import native_build; "
                        "native_build.build()"], cwd=checkout, check=True,
                       env=dict(os.environ, PYTHONPATH=checkout))
    out = {"card": card, "sets": {}}
    with tempfile.TemporaryDirectory(prefix="lrm_walk_ab_") as d:
        n1, len1 = SETS["1kb"]
        fa, fq1, _, g = smoke.make_data(d, args.seed, 4_000_000, n1, len1,
                                        0.03)
        with open(os.path.join(d, "index.log"), "w") as e, \
                contextlib.redirect_stderr(e):
            cli.main(["index", fa])
        fqs = {"1kb": fq1}
        for k, name in enumerate(("10kb", "50kb")):
            n, read_len = SETS[name]
            reads, _, _ = smoke.make_long_reads(g, args.seed + 1 + k, n,
                                                read_len)
            fqs[name] = os.path.join(d, f"{name}.fq")
            smoke.write_fastq(fqs[name], reads)
        for name, fq in fqs.items():
            n = SETS[name][0]
            runs = {"base": [], "new": []}
            sams = {}
            for _ in range(args.rounds):
                for side in ("base", "new", "new", "base"):
                    sam = os.path.join(d, f"{name}.{side}.sam")
                    runs[side].append(run_map(base if side == "base"
                                              else HERE, fa, fq, n, sam))
                    with open(sam) as f:
                        sams[side] = f.read()
                    print(f"[ab] {name} {side}: "
                          f"{json.dumps(runs[side][-1])}", flush=True)
            if sams["base"] != sams["new"]:
                raise AssertionError(f"{name}: the SAMs differ")
            print(f"[ab] {name}: SAM byte-identical between the checkouts",
                  flush=True)
            out["sets"][name] = runs
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
