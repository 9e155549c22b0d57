#!/usr/bin/env python3
"""`cli map` of this checkout against another checkout's (the parent
commit, unpacked with `git archive`) on one NVIDIA GPU, in turns within
one call: reads/s end to end and the mapper's `phase_s` split (prepare,
dispatch, fetch, assemble) of the 1 kb, 10 kb and 50 kb read sets of
chip_smoke.py on its 4 Mb genome, all made from --seed.  With --walks,
the gact walk alone instead: chip_smoke.py phase 3's 50 kb pass at band
5120 and 10 kb retry at band 2176 (the same reads for both checkouts),
each timed as phase 3 times it (CUDA events around each group's walk,
median of 5 calls) and by a torch.profiler trace of one call (the walk
kernel's launches summed), its runs' digest held equal between the
checkouts, beside the lanes' iterations.

  python3 scripts/torch_walk_ab.py --base DIR [--seed N] [--rounds N]
      [--walks]

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


# one checkout's gact walks: argv = checkout, cases file
WALKS = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from longreadmapper_tpu_torch.ops.band_scores import band_checkpoints
from longreadmapper_tpu_torch.ops.gact import gact_traceback_c
out = {}
for name, c in torch.load(sys.argv[2]).items():
    q, t, lens = c["q"].cuda(), c["t"].cuda(), c["lens"].cuda()
    T, W, band, group = c["T"], c["W"], c["band"], c["group"]
    ckpt, _ = band_checkpoints(q, t, T, W, band)

    def run():
        evs = []

        def mark(stage):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs.append(e)

        runs, sat = gact_traceback_c(q, t, ckpt, lens, T, W, band, 1, group,
                                     mark)
        torch.cuda.synchronize()
        return runs, sat, sum(a.elapsed_time(b)
                              for a, b in zip(evs[::2], evs[1::2]))

    runs, sat, _ = run()
    ms = statistics.median(run()[2] for _ in range(5))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    kern = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type.name == "CUDA" and "gact_walk_kernel" in e.name]
    live = ((runs.reshape(runs.shape[0], -1, 2) & 3) != 3).any(dim=2)
    digest = int((runs.to(torch.int64) * (torch.arange(
        runs.numel(), device=runs.device).reshape(runs.shape) % 999983
        + 1)).sum())
    out[name] = dict(ms=ms, kernel_ms=sum(kern), launches=len(kern),
                     saturated=bool(sat), digest=digest,
                     block_iterations=int(live.any(dim=0).sum()),
                     longest_lane=int(live.sum(dim=1).max()))
print(json.dumps(out))
"""


def walk_cases(seed: int, path: str) -> None:
    """chip_smoke.py phase 3's gact passes: the 50 kb pass at band 5120
    and the 10 kb retry at 2176 (PASS_SHAPES), reads from --seed with
    WALK_INDEL's indels, lens as the step masks them; saved to `path`."""
    import numpy as np
    import torch
    import chip_smoke as smoke
    from longreadmapper_tpu_torch.ops.band_scores import band_checkpoints
    from longreadmapper_tpu_torch.ops.gact import gact_group_tiles
    rng = np.random.default_rng(seed)
    cases = {}
    for name, (B, L, W, band) in (("50kb pass", smoke.PASS_SHAPES[0]),
                                  ("10kb retry", smoke.PASS_SHAPES[2])):
        T = 512
        q, t = smoke.dp_inputs(rng, B, L, smoke.WALK_INDEL)
        _, wcol = band_checkpoints(q, t, T, W, band)
        cases[name] = dict(q=q.cpu(), t=t.cpu(),
                           lens=smoke.walk_lens(q, wcol, W).cpu(), T=T, W=W,
                           band=band, group=gact_group_tiles(
                               B, L, T, band, smoke.DIRS_BUDGET))
    torch.save(cases, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--walks", action="store_true",
                    help="the gact walk alone, not cli map")
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
    if args.walks:
        with tempfile.TemporaryDirectory(prefix="lrm_walk_ab_") as d:
            path = os.path.join(d, "cases.pt")
            walk_cases(args.seed, path)
            runs, digests = [], {}
            for r in range(args.rounds):
                for side in ("base", "new", "new", "base"):
                    checkout = base if side == "base" else HERE
                    p = subprocess.run([sys.executable, "-c", WALKS,
                                        checkout, path], capture_output=True,
                                       text=True, timeout=900, cwd=checkout)
                    if p.returncode != 0:
                        raise RuntimeError(f"{side} walks failed:\n"
                                           + p.stderr[-3000:])
                    got = json.loads(p.stdout.strip().splitlines()[-1])
                    runs.append(dict(side=side, round=r, walks=got))
                    for name, w in got.items():
                        print(f"[ab] {side} {name}: {json.dumps(w)}",
                              flush=True)
                        if digests.setdefault(name, w["digest"]) != w[
                                "digest"]:
                            raise AssertionError(f"{name}: the runs differ "
                                                 "between the checkouts")
            out["walks"] = runs
        print(card)
        print(json.dumps(out))
        return 0
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
