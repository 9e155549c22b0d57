"""Command-line entry points of the port, with the JAX CLI's argv contract:

  index  — `... index ref.fa [--hlen N] [--o-ratio N] [--n-seed N]
           [--device cuda|cpu] [--host-only] [--ram-gb G] [--no-devidx]
           [--quiet]`
  map    — `... map ref.fa reads.fq [batch seed thres] [--chunk-b N]
           [--rg-id N] [--device cuda|cpu] [--slim-index] [--quiet]`
           (SAM on stdout)
  mapdist — `... mapdist ref.fa reads.fq [batch seed thres]
           [--out-prefix P] [--chunk-b N] [--rg-id N] [--shard-index]
           [--slim-index] [--model-shards N] [--device cuda|cpu] [--quiet]`
           (one process a device, under `torchrun` or alone; SAM to
           P.part<data index>, runtime/launch.py)
  warmup — `... warmup ref.fa [--lengths 256,1024] [--chunk-b N]
           [--slim-index] [--device cuda|cpu] [--quiet]`

`--device` defaults to `cuda` and fails when no card is present; pass
`--device cpu` to run the plain PyTorch versions.  `index` builds the
lchash on that device, or on the host from the suffix array with
`--host-only`, and the suffix array by the blocked external-memory build
when `--ram-gb` bounds its working set below the in-RAM build's.

Usage: python -m longreadmapper_tpu_torch.cli <index|map|mapdist|warmup> ...

The `accidx-torch` and `accaln-torch` scripts (accidx_main, accaln_main)
are `index` and `map` under the reference's binary names, as the JAX
package's `accidx` and `accaln` are.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

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
    ia.add_argument("--ram-gb", type=float, default=0,
                    help="bound the suffix-array build's working set (GB): "
                         "a text whose in-RAM build (~12 B a char) would "
                         "pass it builds by blocks on disk (byte-identical "
                         ".sa5); 0 = in-RAM (default)")
    ia.add_argument("--no-devidx", action="store_true",
                    help="skip persisting the device-layout cache")
    ia.add_argument("--quiet", action="store_true")

    ma = sub.add_parser(
        "map", help="map reads, SAM to stdout (accaln)",
        description="Map reads, SAM to stdout (accaln).  Reads to 100 kb "
        "(the 100,352 bucket) map with no option: buckets past 2 kb take the "
        "long-read paths, and the full-band retry of reads past ~80 kb keeps "
        "int32 run entries.  Longer reads are untested.")
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

    md = sub.add_parser("mapdist",
                        help="map over every rank of a process group, one "
                             "device a rank (SAM stripes to "
                             "--out-prefix.part<k>)")
    md.add_argument("fasta")
    md.add_argument("reads")
    md.add_argument("pos", nargs="*", type=int)
    md.add_argument("--out-prefix", default="out.sam")
    md.add_argument("--chunk-b", type=int, default=0)
    md.add_argument("--rg-id", type=int, default=0)
    md.add_argument("--shard-index", action="store_true",
                    help="row-shard the six gather tables of the index over "
                         "a 'model' mesh axis instead of replicating them")
    md.add_argument("--slim-index", action="store_true",
                    help="slim index layout; composes with --shard-index")
    md.add_argument("--model-shards", type=int, default=0,
                    help="'model' axis size with --shard-index (default: "
                         "every rank)")
    md.add_argument("--device", default="cuda",
                    help="cuda (NCCL, cuda:<LOCAL_RANK>) or cpu (Gloo)")
    md.add_argument("--quiet", action="store_true")

    wa = sub.add_parser("warmup",
                        help="build the kernels and run every step variant "
                             "of the given read-length buckets once")
    wa.add_argument("fasta")
    wa.add_argument("--lengths", default="256,1024",
                    help="comma-separated read lengths (default 256,1024)")
    wa.add_argument("--chunk-b", type=int, default=2048)
    wa.add_argument("--slim-index", action="store_true",
                    help="warm the slim layout's steps")
    wa.add_argument("--device", default="cuda")
    wa.add_argument("--quiet", action="store_true")

    args = ap.parse_args(argv)

    if args.cmd == "index":
        from .runtime.accidx import build_index
        hlen = args.hlen
        if hlen == 0:
            # the .cat is 2*genome+1; approximated from the FASTA size
            hlen = auto_hlen(2 * os.path.getsize(args.fasta))
            if not args.quiet:
                print(f"[index] auto hlen = {hlen}", file=sys.stderr)
        p = Params(hlen=hlen, o_ratio=args.o_ratio, n_seed=args.n_seed)
        build_index(args.fasta, p, verbose=not args.quiet,
                    devidx=not args.no_devidx,
                    ram_use=int(args.ram_gb * (1 << 30)),
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

    if args.cmd == "warmup":
        from .index.device import load_device_index
        from .models.mapper import TorchMapper
        from .utils.log import new_logger
        log = new_logger(verbose=not args.quiet)
        idx, meta, mta = load_device_index(args.fasta, args.device,
                                           slim=args.slim_index,
                                           verbose=not args.quiet)
        mapper = TorchMapper(idx, meta, mta, read_params(),
                             chunk_b=args.chunk_b, device=args.device)
        lengths = [int(x) for x in args.lengths.split(",") if x]
        dt = mapper.warmup(lengths)
        log.vlog("warmed %d bucket(s) in %.1fs", len(lengths), dt)
        return 0

    from .runtime.launch import run_distributed
    if len(args.pos) == 3:
        p = Params(batch_size=args.pos[0], seed_len=args.pos[1],
                   thres=args.pos[2])
    else:
        p = read_params("params")
    run_distributed(args.fasta, args.reads, p, out_prefix=args.out_prefix,
                    rg_id=args.rg_id, chunk_b=args.chunk_b,
                    shard_index_tables=args.shard_index,
                    model_shards=args.model_shards, slim=args.slim_index,
                    verbose=not args.quiet, device=args.device)
    return 0


def accidx_main() -> int:
    """Drop-in `accidx ref.fa` entry point (asindex.c:129 argv contract),
    the `accidx-torch` script: `index` with the given arguments."""
    return main(["index", *sys.argv[1:]])


def accaln_main() -> int:
    """Drop-in `accaln ref.fa reads.fq [batch seed thres]` entry point
    (alnmain.c:560-571 argv contract, `params` file fallback included),
    the `accaln-torch` script: `map` with the given arguments."""
    return main(["map", *sys.argv[1:]])


if __name__ == "__main__":
    sys.exit(main())
