#!/usr/bin/env python3
"""The mapping step's stage split of this checkout against another
checkout's (the parent commit, unpacked with `git archive`) on one NVIDIA
GPU, in turns within one call: `runtime/stages.py::stage_times` (per-stage
ms, the seed vote's stages, the whole step unsynced, and a device trace of
one step: kernels and busy share) on the 1 kb, 10 kb and 50 kb read sets
of chip_smoke.py on its 4 Mb genome, all made from --seed.

  python3 scripts/torch_vote_ab.py --base DIR [--seed N] [--rounds N]

The index is built once by this checkout (`cli index`, the lchash on the
card); both checkouts read the same artifacts and `.devidx` cache.  Each
round runs base, new, new, base, each checkout in a fresh process that
builds its kernels (not timed), loads the index once and times the three
sets.  The JSON printed last holds every run's stage times and traces,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# set -> (reads timed, read length); 2048-read chunks
SETS = {"1kb": (8192, 1000), "10kb": (800, 10_000), "50kb": (160, 50_000)}

# one checkout's stage times: argv = checkout, fasta, reads pickle
STAGES = r"""
import json, pickle, sys
sys.path.insert(0, sys.argv[1])
from longreadmapper_tpu_torch import native_build
native_build.build()
from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.runtime.stages import stage_times
index = load_device_index(sys.argv[2], "cuda", verbose=False)
with open(sys.argv[3], "rb") as f:
    sets = pickle.load(f)
out = {name: stage_times(sys.argv[2], reads, chunk_b=2048, device="cuda",
                         traced_steps=1, index=index)
       for name, reads in sets.items()}
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import pickle
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from longreadmapper_tpu_torch import cli
    base = os.path.abspath(args.base)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = []
    with tempfile.TemporaryDirectory(prefix="lrm_vote_ab_") as d:
        fa, fq, _, g = smoke.make_data(d, args.seed, 4_000_000,
                                       SETS["1kb"][0], SETS["1kb"][1], 0.03)
        with open(os.path.join(d, "index.log"), "w") as e, \
                contextlib.redirect_stderr(e):
            cli.main(["index", fa])
        from longreadmapper_tpu_torch.runtime.reads import load_read_batches
        sets = {"1kb": next(iter(load_read_batches(
            fq, SETS["1kb"][0], background=False)))}
        for k, name in enumerate(("10kb", "50kb")):
            n, read_len = SETS[name]
            reads, _, _ = smoke.make_long_reads(g, args.seed + 1 + k, n,
                                                read_len)
            sets[name] = [(nm, s, None) for nm, s in reads]
        pkl = os.path.join(d, "sets.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(sets, f)
        for r in range(args.rounds):
            for who in ("base", "new", "new", "base"):
                checkout = base if who == "base" else HERE
                p = subprocess.run([sys.executable, "-c", STAGES, checkout,
                                    fa, pkl], capture_output=True, text=True,
                                   timeout=1200, cwd=checkout)
                if p.returncode != 0:
                    print(p.stderr[-3000:], file=sys.stderr)
                    raise RuntimeError(f"{who} stage times exited "
                                       f"{p.returncode}")
                out = json.loads(p.stdout.strip().splitlines()[-1])
                runs.append(dict(who=who, round=r, stages=out))
                for name, st in out.items():
                    print(f"[{who}] {name}: step {st['step_ms']} ms, "
                          f"stages {json.dumps(st['stage_ms'])}, trace "
                          f"{json.dumps(st['trace'])}", flush=True)
    print(card)
    print(json.dumps(dict(card=card, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
