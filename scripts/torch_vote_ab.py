#!/usr/bin/env python3
"""The mapping step's stage split, the step glue's kernels and the seed
tables kernel alone, of this checkout against another checkout's (the
parent commit, unpacked with `git archive`) on one NVIDIA GPU, in turns
within one call:
`runtime/stages.py::stage_times` (per-stage ms, the seed vote's stages,
the whole step unsynced, and a device trace of one step: kernels and busy
share) on the 1 kb, 10 kb and 50 kb read sets of chip_smoke.py on its 4
Mb genome, all made from --seed; the step glue's four kernels on each
set's first chunk by the checkout's own `chip_smoke.glue_case` (each held
bit-equal to its plain version; the wrapper's CUDA-event median and the
kernel's device time from a trace, GLUE_TURNS calls each, beside
`glue_bounds`); walk_c_kernel and pack_kernel alone (a trace of 50
calls each) on the route the checkout's step takes at the 1 kb and 10 kb
buckets (walk_c on the lanes' inputs, or on the values of a lanes
launch), their outputs held equal by digest; and `seed_tables` on each
set's first chunk and on the 1 kb chunk of phase 3b's repeat genome
(wide seeds):
the wrapper's CUDA-event median over VOTE_TURNS calls, and the kernel's
own device time from a torch.profiler trace of as many calls, its
outputs' digest held equal between the checkouts.

  python3 scripts/torch_vote_ab.py --base DIR [--seed N] [--rounds N]

The index is built once by this checkout (`cli index`, the lchash on the
card); both checkouts read the same artifacts and `.devidx` cache.  Each
checkout first builds its kernels (not timed); then each round runs base,
new, new, base, each checkout in a fresh process
that loads the index once and times the three sets.  The JSON printed
last holds every run's numbers and the card's name and power limit.
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

# one checkout's numbers: argv = checkout, fasta, reads pickle, timed calls,
# the repeat genome's fasta
STAGES = r"""
import json, pickle, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from longreadmapper_tpu_torch import native_build
native_build.build()
from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops.seed_vote import seed_tables
from longreadmapper_tpu_torch.runtime.stages import stage_times
from longreadmapper_tpu_torch.utils.config import Params
index = load_device_index(sys.argv[2], "cuda", verbose=False)
with open(sys.argv[3], "rb") as f:
    sets = pickle.load(f)
out = {"stages": {
    name: stage_times(sys.argv[2], reads, chunk_b=2048, device="cuda",
                      traced_steps=1, index=index)
    for name, (reads, _) in sets.items() if name != "repeat"}}
# the step glue's four kernels on each set's first chunk, by the
# checkout's own chip_smoke.glue_case: each held bit-equal to its plain
# version, the wrapper's CUDA-event median and the kernel alone (trace)
import chip_smoke
mapper = TorchMapper(*index, Params(), chunk_b=2048, device="cuda")
out["glue"] = {}
for name, (reads, _) in sets.items():
    if name != "repeat":
        res = {}
        chip_smoke.glue_case("ab", name, mapper, reads, res)
        out["glue"][name] = res
# walk_c and pack_kernel alone on the route the checkout's map_step
# takes (walk_c on G3's inputs, a step.Lanes, where the checkout has one,
# else on the values of its own lanes launch) at the resident buckets,
# outputs held equal between the checkouts by digest
from longreadmapper_tpu_torch.ops import step as S
from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
from longreadmapper_tpu_torch.ops.seed_vote import vote_rows, wide_rank
from longreadmapper_tpu_torch.ops.traceback import device_traceback_c


def digest(t):
    t = t.reshape(-1).to(torch.int64)
    return int((t * (torch.arange(t.numel(), device=t.device) % 999983
                     + 1)).sum())


out["carriers"] = {}
for name, (reads, _) in sets.items():
    if name not in ("1kb", "10kb"):
        continue
    L, prepped = mapper._prepare_chunk(reads[:mapper.B])
    cfg = mapper._step_for(L)
    _, raw, _, lens, limits = prepped[0]
    raw, lens, limit = (torch.from_numpy(a).cuda() for a in (raw, lens,
                                                             limits))
    codes, codes_rc = S.encode_raw(raw, lens)
    tabs = seed_tables(cfg, mapper.idx, codes, lens)
    best, ovf, _ = vote_rows(cfg, mapper.idx, lens, tabs, wide_rank(tabs[3]))
    found, gi, strand, off, _, _, q, t = S.locate_window(
        cfg, mapper.idx, best, lens, codes, codes_rc)
    Wp = cfg.short_W
    vdirs, wcol, nm = banded_nw_dirs(q, t, Wp, cfg.short_band)
    dt = torch.int16 if cfg.tb_entry_bytes == 2 else torch.int32
    ln = S.lanes(wcol, lens, limit, found, ovf, Wp, Wp < cfg.W)
    head = (cfg, best, found, gi, strand, off)
    if hasattr(S, "Lanes"):
        walk = lambda: device_traceback_c(vdirs, ln, cfg.L, Wp, nm, dt)
        runs = walk()
        packf = lambda: S.pack(*head, ln, limit, runs, None)
    else:
        ed, short, ov, lens_tb = ln
        walk = lambda: device_traceback_c(vdirs, lens_tb, cfg.L, Wp, nm, dt)
        runs = walk()
        packf = lambda: S.pack(*head, ed, limit, short, ov, runs, None)
    res = dict(runs=digest(runs), blob=digest(packf()["blob"]))
    for kern, fn in (("walk_c_kernel", walk), ("pack_kernel", packf)):
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type.name == "CUDA" and kern in e.name]
        res[kern] = statistics.median(ts) if ts else None
        res[kern + "_traced"] = len(ts)
    out["carriers"][name] = res
del mapper
out["tables"] = {}
for name, (reads, L) in sets.items():
    if name == "repeat":
        index = load_device_index(sys.argv[5], "cuda", verbose=False)
    idx, meta, mta = index
    mapper = TorchMapper(idx, meta, mta, Params(), chunk_b=2048,
                         device="cuda")
    cfg = mapper._step_for(L)
    codes, _, lens, _ = mapper._pack_reads(reads[:cfg.B], L, cfg.B)
    codes = torch.from_numpy(codes).cuda()
    lens = torch.from_numpy(lens).cuda()
    fn = lambda: seed_tables(cfg, idx, codes, lens)
    tabs = fn()
    digest = [int((t.reshape(-1).to(torch.int64) * (torch.arange(
        t.numel(), device=t.device) % 999983 + 1)).sum()) for t in tabs]
    fn()
    ms = []
    for _ in range(int(sys.argv[4])):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(int(sys.argv[4])):
            fn()
        torch.cuda.synchronize()
    kern = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type.name == "CUDA"
            and "seed_tables_kernel" in e.name]
    out["tables"][name] = dict(
        B=cfg.B, L=L, seeds=int(tabs[0].numel()),
        wide=int(tabs[3].sum()), wrapper_ms=statistics.median(ms),
        kernel_ms=statistics.median(kern) if kern else None,
        kernel_launches=len(kern), digest=digest)
print(json.dumps(out))
"""
VOTE_TURNS = 20                    # timed seed_tables calls, as the smoke's


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
    for checkout in (base, HERE):
        subprocess.run([sys.executable, "-c",
                        "from longreadmapper_tpu_torch import native_build; "
                        "native_build.build()"], cwd=checkout, check=True,
                       env=dict(os.environ, PYTHONPATH=checkout))
    with tempfile.TemporaryDirectory(prefix="lrm_vote_ab_") as d:
        fa, fq, _, g = smoke.make_data(d, args.seed, 4_000_000,
                                       SETS["1kb"][0], SETS["1kb"][1], 0.03)
        with open(os.path.join(d, "index.log"), "w") as e, \
                contextlib.redirect_stderr(e):
            cli.main(["index", fa])
        from longreadmapper_tpu_torch.runtime.reads import load_read_batches
        sets = {"1kb": (next(iter(load_read_batches(
            fq, SETS["1kb"][0], background=False))), 1024)}
        for k, name in enumerate(("10kb", "50kb")):
            n, read_len = SETS[name]
            reads, _, _ = smoke.make_long_reads(g, args.seed + 1 + k, n,
                                                read_len)
            sets[name] = ([(nm, s, None) for nm, s in reads],
                          smoke.VOTE_SETS[name])
        # phase 3b's repeat genome (wide seeds): its 1 kb chunk, tables only
        rfa, rreads = smoke.repeat_genome(d, args.seed)
        sets["repeat"] = ([(nm, s, None) for nm, s in rreads], 1024)
        pkl = os.path.join(d, "sets.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(sets, f)
        digests = {}
        for r in range(args.rounds):
            for who in ("base", "new", "new", "base"):
                checkout = base if who == "base" else HERE
                p = subprocess.run([sys.executable, "-c", STAGES, checkout,
                                    fa, pkl, str(VOTE_TURNS), rfa],
                                   capture_output=True, text=True,
                                   timeout=1200, cwd=checkout)
                if p.returncode != 0:
                    print(p.stderr[-3000:], file=sys.stderr)
                    raise RuntimeError(f"{who} stage times exited "
                                       f"{p.returncode}")
                out = json.loads(p.stdout.strip().splitlines()[-1])
                runs.append(dict(who=who, round=r, **out))
                for name, st in out["stages"].items():
                    print(f"[{who}] {name}: step {st['step_ms']} ms, "
                          f"stages {json.dumps(st['stage_ms'])}, trace "
                          f"{json.dumps(st['trace'])}", flush=True)
                for name, st in out["glue"].items():
                    print(f"[{who}] {name} glue (wrapper ms, kernel ms): "
                          + json.dumps({k: (v.get("ms"), v.get("kernel_ms"))
                                        for k, v in st.items()}), flush=True)
                for name, st in out["carriers"].items():
                    print(f"[{who}] {name} carriers alone (ms): "
                          + json.dumps(st), flush=True)
                    dig = (st["runs"], st["blob"])
                    if digests.setdefault(name + " carriers", dig) != dig:
                        raise AssertionError(f"{name}: the walk's runs or "
                                             "the blob differ between the "
                                             "checkouts")
                for name, st in out["tables"].items():
                    print(f"[{who}] {name} seed_tables: wrapper "
                          f"{st['wrapper_ms']} ms, kernel {st['kernel_ms']} "
                          f"ms ({st['kernel_launches']} traced), "
                          f"{st['seeds']} seeds, {st['wide']} wide",
                          flush=True)
                    if digests.setdefault(name, st["digest"]) != st["digest"]:
                        raise AssertionError(f"{name}: seed_tables' outputs "
                                             "differ between the checkouts")
    print(card)
    print(json.dumps(dict(card=card, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
