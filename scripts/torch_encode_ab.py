#!/usr/bin/env python3
"""encode_kernel (csrc/step.cu, ops/step.py::encode_raw) alone on one
NVIDIA GPU, in one or more checkouts of the repository taken in turns: at
the three buckets' shapes, 1 kb (B 2048, L 1024), 10 kb (200, 10240) and
50 kb (40, 50176), on rows of one length (1000, 10000 and 50000 bases, as
chip_smoke.py phase 3c) and on ragged rows (lengths uniform over the
bucket's upper half, 513-1024, 8193-10240, 49153-50176, and zero past
each), random bases made with numpy from --seed.  A checkout whose
encode_raw takes one length (its second parameter named L0) runs the rows
of one length alone.  Each time is the median device ms of a launch over
--calls calls in a torch.profiler trace (chip_smoke.py's trace_ms).

  python3 scripts/torch_encode_ab.py [--roots DIR ...] [--calls N]
                                     [--seed N]

Each root (default: this checkout) runs in a process of its own, in the
order given (list one twice to take turns: A B B A).  The JSON printed
last holds every time with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"1kb": (2048, 1024, 1000), "10kb": (200, 10240, 10000),
          "50kb": (40, 50176, 50000)}


def one(root: str, calls: int, seed: int) -> dict:
    """The times of `root`'s encode_kernel, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, HERE)
    import numpy as np
    import torch
    from chip_smoke import trace_ms
    from longreadmapper_tpu_torch.ops import step as S
    per_row = "lens" in inspect.signature(S.encode_raw).parameters
    assert os.path.abspath(S.__file__).startswith(os.path.abspath(root))
    rng = np.random.default_rng(seed)
    out = {}
    for name, (B, L, L0) in SHAPES.items():
        cases = {"uniform": np.full(B, L0, np.int32)}
        if per_row:
            cases["ragged"] = rng.integers(L // 2 + 1, L + 1, B).astype(
                np.int32)
        for kind, lens in cases.items():
            raw = rng.integers(0, 4, (B, L)).astype(np.uint8)
            raw = np.frombuffer(b"ACGT", np.uint8)[raw]
            raw[np.arange(L)[None, :] >= lens[:, None]] = 0
            draw = torch.from_numpy(raw).cuda()
            arg = (torch.from_numpy(lens).cuda() if per_row
                   else int(lens.max()))
            out[f"{name}.{kind}"] = trace_ms(
                lambda: S.encode_raw(draw, arg), "encode_kernel", calls)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", default=[HERE])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.calls, args.seed)))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for root in args.roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root, "--calls", str(args.calls),
                              "--seed", str(args.seed)],
                             capture_output=True, text=True, check=True)
        runs.append(dict(root=root, ms=json.loads(
            res.stdout.strip().splitlines()[-1])))
        print(f"[encode] {root}: {json.dumps(runs[-1]['ms'])}", flush=True)
    print(json.dumps(dict(card=card, calls=args.calls, runs=runs)))


if __name__ == "__main__":
    main()
