"""The control of the comparison that decides `correct`: the plain reference
put in the program's place with one guarantee of the configuration broken,
judged as a run's records are.  It must come out wrong.

The broken guarantee: every read whose distance is within the limit maps.
The control drops the full-band retry tier, so a read whose distance
reaches its bucket's first-pass half band (512 at 10 kb, 2508 at 50 kb)
is reported unmapped, the step a later change could be tempted to take.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

runs it at the cell's own size (genome, pool, sample) on the card and
prints one JSON line a seed.  A benchmark run never runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_counts(cell: dict, seed: int, device) -> dict:
    """records_wrong of the control's records against the reference's, on
    the sample a run of `cell` would judge, its kept chunks the pool's."""
    from benchmark.judge import fields_of, judge
    from benchmark.reference import Reference, first_pass_band
    from benchmark.run import full_band, sample
    from benchmark.traffic import make_genome, make_pool

    config, traffic = cell["config"], cell["traffic"]
    genome = make_genome(config["genome"], seed)
    pool = make_pool(genome, traffic, seed, device)
    kept = {k: (k, None) for k in range(pool.n_chunks)}
    picks = sample(pool, kept, traffic["check"], seed)
    reads = [(f"c0.r{i}", pool.seqs[i]) for _, i in picks]
    ref = Reference(genome, int(config["mapper"]["seed_len"]),
                    int(config["mapper"]["thres"]), device)
    seqs = [s for _, s in reads]
    exp = ref.map_reads(seqs)
    ctl = [replace(e, ed=-1, valid=False)
           if e.valid and e.ed >= first_pass_band(len(s)) else e
           for e, s in zip(exp, seqs)]
    recs = [fields_of(c, name, s, ref) for c, (name, s) in zip(ctl, reads)]
    counts = judge(recs, reads, exp, ref, check_cigar=False)
    del counts["wrong"]
    counts["sampled"] = len(picks)
    counts["sampled_full_band"] = full_band(exp, seqs)
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
