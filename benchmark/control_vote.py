"""A second control of the comparison that decides `correct`, for the
vote: the plain reference put in the program's place with the exact vote
tier taken away, judged as a run's records are.  It must come out wrong
in a cell whose reads cross repeat copies (the yeast cells: Ty, Y', X).

The broken guarantee: every read votes over all its seeds' occurrences.
The program votes each (read, phase) row in a compact tier of
compact_slots(...) slots and votes a read whose row overflows them again
in the exact tier (ROADMAP.md C1).  Without that tier such a read is
reported unmapped: the control drops every read whose widest row, its
informative seeds' occurrences in one phase as the reference counts them,
passes the compact slots.  The program's rows also hold the background
hits of each seed's hlen-mer, so it overflows at least these reads.

    python3 benchmark/control_vote.py --workload <name> --seeds <n> [<n> ...]

runs it at the cell's own size (genome, pool, sample) on the card and
prints one JSON line a seed.  A benchmark run never runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compact_slots(L: int, n: int, seed_len: int, hlen: int) -> int:
    """The compact tier's slots a (read, phase) row at bucket L over a
    text of n positions: the row's seeds' self-hits and their hlen-mers'
    background lam = n / 4^hlen, mean + 5 sigma, 16-granular, at least 64
    and at most the exact tier's (self-hits and 2 lam, 128-granular)."""
    from benchmark.reference import GAP_LEN
    step = seed_len + GAP_LEN
    seeds = max(1, -(-(L - seed_len) // step)) if L > seed_len else 1
    lam = n / float(4 ** hlen)
    exact = -(-max(int(seeds * (1 + 2 * max(lam, 0.5))) + 64, 128)
              // 128) * 128
    mean = seeds * (1 + max(lam, 0.05))
    want = int(mean + 5.0 * (seeds * max(lam, 0.05)) ** 0.5) + 16
    return min(exact, max(64, -(-want // 16) * 16))


def widest_rows(ref, seqs: list) -> np.ndarray:
    """Each read's widest (read, phase) row: its informative seeds'
    occurrences (0 < count < thres) in its fullest phase."""
    from benchmark.reference import GAP_LEN
    phases = ref.seed_len + GAP_LEN
    _, occ = ref._occurrences(seqs)
    return np.array([int(np.bincount(j % phases, minlength=phases).max())
                     for j, _ in occ], np.int64)


def control_counts(cell: dict, seed: int, device) -> dict:
    """records_wrong of the control's records against the reference's, on
    the sample a run of `cell` would judge, its kept chunks the pool's."""
    from benchmark.judge import fields_of, judge
    from benchmark.reference import Reference, bucket_len
    from benchmark.run import sample
    from benchmark.traffic import make_genome, make_pool

    config, traffic = cell["config"], cell["traffic"]
    mapper = config["mapper"]
    genome = make_genome(config["genome"], seed)
    pool = make_pool(genome, traffic, seed, device)
    kept = {k: (k, None) for k in range(pool.n_chunks)}
    picks = sample(pool, kept, traffic["check"], seed)
    reads = [(f"c0.r{i}", pool.seqs[i]) for _, i in picks]
    ref = Reference(genome, int(mapper["seed_len"]), int(mapper["thres"]),
                    device)
    seqs = [s for _, s in reads]
    exp = ref.map_reads(seqs)
    rows = widest_rows(ref, seqs)
    slots = [compact_slots(bucket_len(len(s)), len(ref.cat), ref.seed_len,
                           int(mapper["hlen"])) for s in seqs]
    over = rows > np.array(slots)
    ctl = [replace(e, ed=-1, valid=False) if e.valid and o else e
           for e, o in zip(exp, over)]
    recs = [fields_of(c, name, s, ref) for c, (name, s) in zip(ctl, reads)]
    counts = judge(recs, reads, exp, ref, check_cigar=False)
    del counts["wrong"]
    counts["sampled"] = len(picks)
    counts["sampled_over_compact"] = int(over.sum())
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                            != os.path.join(ROOT, "benchmark")]
    from benchmark.run import cell_of, load_json
    cell = cell_of(load_json(ROOT, "BENCHMARK.json"), args.workload)
    for s in args.seeds:
        c = control_counts(cell, s, args.device)
        print(json.dumps(dict(workload=args.workload, seed=s, **c)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
