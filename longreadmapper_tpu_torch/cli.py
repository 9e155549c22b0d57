"""Command-line entry points of the port, with the JAX CLI's argv contract:

  index  — `... index ref.fa [--hlen N] [--o-ratio N] [--n-seed N]
           [--device cuda|cpu] [--host-only] [--no-devidx] [--quiet]`
  map    — `... map ref.fa reads.fq [batch seed thres] [--chunk-b N]
           [--rg-id N] [--device cuda|cpu] [--slim-index] [--quiet]`
           (SAM on stdout)

`--device` defaults to `cuda` and fails when no card is present; pass
`--device cpu` to run the plain PyTorch versions.  `index` builds the
lchash on that device, or on the host from the suffix array with
`--host-only`.  `mapdist`, `warmup` and `index --ram-gb` raise
NotImplementedError.

Usage: python -m longreadmapper_tpu_torch.cli <index|map> ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .device import roadmap_gap
from .utils.config import Params, auto_hlen, read_params


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="longreadmapper_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ia = sub.add_parser("index", help="build the reference index (accidx)")
    ia.add_argument("fasta")
    ia.add_argument("--hlen", type=int, default=0,
                    help="lchash k-mer length; 0 = auto (14 for any genome "
                         ">= 1 Mb, 12 below)")
    ia.add_argument("--o-ratio", type=int, default=32)
    ia.add_argument("--n-seed", type=int, default=0)
    ia.add_argument("--device", default="cuda",
                    help="torch device of the lchash build (default cuda; "
                         "cpu runs the plain PyTorch version)")
    ia.add_argument("--host-only", action="store_true",
                    help="build the lchash on the host from the suffix "
                         "array instead of on --device")
    ia.add_argument("--ram-gb", type=float, default=0)
    ia.add_argument("--no-devidx", action="store_true",
                    help="skip persisting the device-layout cache")
    ia.add_argument("--quiet", action="store_true")

    ma = sub.add_parser("map", help="map reads, SAM to stdout (accaln)")
    ma.add_argument("fasta")
    ma.add_argument("reads")
    ma.add_argument("pos", nargs="*", type=int,
                    help="optional: batch_size seed_len thres "
                         "(else ./params file, else defaults 1000/20/300)")
    ma.add_argument("--chunk-b", type=int, default=2048,
                    help="reads per device chunk (default 2048)")
    ma.add_argument("--rg-id", type=int, default=None,
                    help="@RG timestamp id (default: current time; pass 0 "
                         "for reproducible output)")
    ma.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    ma.add_argument("--slim-index", action="store_true",
                    help="slim index layout: the SA without its context "
                         "column, each vote's verify window rebuilt from "
                         "the text (about 3.5 B a position less)")
    ma.add_argument("--quiet", action="store_true")

    for name in ("mapdist", "warmup"):
        sp = sub.add_parser(name, help="not ported (ROADMAP.md A11)")
        sp.add_argument("rest", nargs=argparse.REMAINDER)

    args = ap.parse_args(argv)

    if args.cmd == "index":
        from .runtime.accidx import build_index
        if args.ram_gb > 0:
            raise roadmap_gap("index --ram-gb (external-memory SA build)",
                              "A12")
        hlen = args.hlen
        if hlen == 0:
            # the .cat is 2*genome+1; approximated from the FASTA size
            hlen = auto_hlen(2 * os.path.getsize(args.fasta))
            if not args.quiet:
                print(f"[index] auto hlen = {hlen}", file=sys.stderr)
        p = Params(hlen=hlen, o_ratio=args.o_ratio, n_seed=args.n_seed)
        build_index(args.fasta, p, verbose=not args.quiet,
                    devidx=not args.no_devidx,
                    device=None if args.host_only else args.device)
        return 0

    if args.cmd == "map":
        from .runtime.accaln import run_mapping
        if len(args.pos) == 3:
            p = Params(batch_size=args.pos[0], seed_len=args.pos[1],
                       thres=args.pos[2])
        elif len(args.pos) == 0:
            p = read_params("params")
        else:
            ap.error("map takes either 0 or 3 positional parameters "
                     "(batch_size seed_len thres)")
        rg_id = args.rg_id if args.rg_id is not None else int(time.time())
        run_mapping(args.fasta, args.reads, p, sys.stdout, rg_id=rg_id,
                    chunk_b=args.chunk_b, verbose=not args.quiet,
                    device=args.device, slim=args.slim_index)
        return 0

    raise roadmap_gap(f"the `{args.cmd}` subcommand", "A11")


if __name__ == "__main__":
    sys.exit(main())
