#!/usr/bin/env python3
"""Measures the design constants of three kernels on one NVIDIA GPU:

  * csrc/walk.cu::walk_c_kernel: the lanes (warps) a CTA, kWalkLanes, how
    far ahead a lane loads its columns, kWalkAhead (its ring kWalkRing
    the smallest power of 2 of at least 3 * kWalkAhead + 1), and the
    least groups of a column's window, kWalkGroups, on chip_smoke.py
    phase 3's resident passes, 1 kb (MAIN_SHAPE) and 10 kb (WIDE_MAIN);
  * csrc/walk.cu::gact_walk_kernel: the warps a CTA, kGactWarps (all of
    them rebuild the rows in the group's last CTA), the lanes a CTA walks,
    kGactLanes, and how far ahead a lane loads its columns, kAhead (its
    ring kRing the smallest power of 2 of at least 3 * kAhead + 1), on
    chip_smoke.py phase 3's 50 kb pass at band 5120 and 10 kb retry at
    band 2176;
  * csrc/vote.cu::seed_tables_kernel: its threads a CTA, kSeedThreads, and
    seeds a thread, kSeedsPerThread, on the first chunk of chip_smoke.py's
    1 kb, 10 kb and 50 kb sets and of phase 3b's repeat genome.

Each variant is the checkout's source with those constants rewritten,
built by nvcc with native_build's flags (all builds at once), and run in
place of the checkout's own library: its outputs are held bit-equal to
the checkout's build, and the variants are timed in turns (the gact walk:
CUDA events around each group's walk, as phase 3; walk_c and the tables:
the kernel's device time from one torch.profiler trace of VOTE_TURNS
calls of each variant in each round).

  python3 scripts/torch_walk_tables_sweep.py [--rounds N] [--seed N]
      [--parts walk_c,gact_walk,seed_tables]

The JSON printed last holds every median (ms) with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (kGactWarps, kGactLanes, kAhead); the checkout's own first
WALK_VARIANTS = ((16, 4, 2), (8, 8, 2), (8, 4, 2), (8, 4, 1), (16, 4, 1),
                 (16, 8, 2), (16, 2, 2), (32, 4, 2))
# (kWalkLanes, kWalkAhead, kWalkGroups); the checkout's own first
WALK_C_VARIANTS = ((2, 1, 8), (1, 1, 8), (4, 1, 8), (8, 1, 8), (2, 2, 8),
                   (2, 3, 8), (2, 1, 24), (2, 1, 56), (2, 2, 24), (1, 2, 8))
# (kSeedThreads, kSeedsPerThread); the checkout's own first
TABLE_VARIANTS = ((512, 2), (256, 4), (256, 2))
VOTE_TURNS = 20


def ring(ahead: int) -> int:
    r = 1
    while r < 3 * ahead + 1:
        r *= 2
    return r


def rewrite(text: str, consts: dict) -> str:
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise AssertionError(f"{name}: {n} definitions in the source")
    return text


def build_variants(d: str, jobs: dict, edit=None) -> dict:
    """{tag: (source name, constants)} -> {tag: library path}, every nvcc
    started at once; `edit`, where given, rewrites each source's text
    before its constants are."""
    from longreadmapper_tpu_torch import native_build
    procs = {}
    for tag, (name, consts) in jobs.items():
        with open(native_build.source(name)) as f:
            text = f.read()
        text = rewrite(edit(text) if edit else text, consts)
        src = os.path.join(d, f"{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(d, f"lib{tag}.so")
        procs[tag] = (subprocess.Popen(native_build._nvcc(src, out),
                                       stderr=subprocess.PIPE, text=True),
                      out)
    libs = {}
    for tag, (p, out) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc exit {p.returncode}\n{err}")
        kern = [l for l in err.splitlines() if "Used" in l or "spill" in l]
        print(f"[sweep] built {tag}: {' | '.join(kern[-4:])}", flush=True)
        libs[tag] = out
    return libs


def load(path: str, functions: dict):
    lib = ctypes.CDLL(path)
    for fn, spec in functions.items():
        argtypes, restype = (spec if isinstance(spec, tuple)
                             else (spec, ctypes.c_int))
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


@contextlib.contextmanager
def using(name: str, lib):
    """The wrappers' native_build.load(name) returns `lib` meanwhile."""
    from longreadmapper_tpu_torch import native_build
    old = native_build._libs.pop(name, None)
    native_build._libs[name] = lib
    try:
        yield
    finally:
        native_build._libs.pop(name)
        if old is not None:
            native_build._libs[name] = old


def sweep_walk(rng, libs: dict, rounds: int) -> dict:
    import torch
    import chip_smoke as smoke
    from longreadmapper_tpu_torch.ops.band_scores import band_checkpoints
    from longreadmapper_tpu_torch.ops.gact import (gact_group_tiles,
                                                   gact_traceback_c)
    from longreadmapper_tpu_torch.ops.traceback import WALK_FUNCS
    out = {}
    for name, (B, L, W, band) in (("50kb pass", smoke.PASS_SHAPES[0]),
                                  ("10kb retry", smoke.PASS_SHAPES[2])):
        T = 512
        q, t = smoke.dp_inputs(rng, B, L, smoke.WALK_INDEL)
        ckpt, wcol = band_checkpoints(q, t, T, W, band)
        lens = smoke.walk_lens(q, wcol, W)
        group = gact_group_tiles(B, L, T, band, smoke.DIRS_BUDGET)
        ms = {tag: [] for tag in libs}
        want = None
        for r in range(rounds + 1):
            order = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for tag in order:
                with using("walk", load(libs[tag], WALK_FUNCS)):
                    runs, sat, t_ms = smoke.gact_walk_ms(
                        gact_traceback_c, q, t, ckpt, lens, T, W, band, 1,
                        group)
                if want is None:
                    want = (runs, bool(sat))
                elif not (torch.equal(runs, want[0])
                          and bool(sat) == want[1]):
                    raise AssertionError(f"gact_walk {tag} differs at "
                                         f"{name}")
                if r:                              # round 0 warms up
                    ms[tag].append(t_ms)
        out[name] = {tag: statistics.median(v) for tag, v in ms.items()}
        print(f"[sweep] gact_walk {name}: {json.dumps(out[name])}",
              flush=True)
    return out


def traced_turns(libs: dict, functions: dict, name: str, kernel: str,
                 fn, rounds: int) -> dict:
    """{tag: median device ms of `kernel`} over one torch.profiler trace
    of `rounds` rounds that call fn VOTE_TURNS times with each variant's
    library loaded as `name`, in order on even rounds and in reverse on
    odd ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    order = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(rounds):
            for tag in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                with using(name, load(libs[tag], functions)):
                    for _ in range(VOTE_TURNS):
                        fn()
                order.append(tag)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type.name == "CUDA"
                 and kernel in e.name), key=lambda e: e.time_range.start)
    if len(ev) != VOTE_TURNS * len(order):
        raise AssertionError(f"{len(ev)} {kernel} launches traced, "
                             f"{VOTE_TURNS * len(order)} made")
    ms = {tag: [] for tag in libs}
    for i, tag in enumerate(order):
        ms[tag].extend(e.time_range.elapsed_us() / 1e3 for e in
                       ev[i * VOTE_TURNS:(i + 1) * VOTE_TURNS])
    return {tag: statistics.median(v) for tag, v in ms.items()}


def sweep_walk_c(rng, libs: dict, rounds: int) -> dict:
    import torch
    import chip_smoke as smoke
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    from longreadmapper_tpu_torch.ops.traceback import (WALK_FUNCS,
                                                        device_traceback_c)
    out = {}
    for name, (B, L, W, band), indel in (
            ("1kb", smoke.MAIN_SHAPE, 0.0),
            ("10kb", smoke.WIDE_MAIN, smoke.WALK_INDEL)):
        dt = torch.int16 if max(L, band - W) < 8192 else torch.int32
        q, t = smoke.dp_inputs(rng, B, L, indel)
        v, wcol, nm = banded_nw_dirs(q, t, W, band)
        lens = smoke.walk_lens(q, wcol, W)
        want = None
        for tag in libs:                        # warm-up and bit-equality
            with using("walk", load(libs[tag], WALK_FUNCS)):
                runs = device_traceback_c(v, lens, L, W, nm, dt)
            if want is None:
                want = runs
            elif not torch.equal(runs, want):
                raise AssertionError(f"walk_c {tag} differs at {name}")
        out[name] = traced_turns(
            libs, WALK_FUNCS, "walk", "walk_c_kernel",
            lambda: device_traceback_c(v, lens, L, W, nm, dt), rounds)
        print(f"[sweep] walk_c {name} (B {B}, L {L}): "
              f"{json.dumps(out[name])}", flush=True)
        del v, nm, wcol
    return out


def sweep_tables(d: str, seed: int, libs: dict, rounds: int) -> dict:
    import torch
    import chip_smoke as smoke
    from longreadmapper_tpu_torch import cli
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch.ops.seed_vote import seed_tables
    from longreadmapper_tpu_torch.ops.vote import VOTE_FUNCS
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches
    fa, fq, _, g = smoke.make_data(d, seed, 4_000_000, 2048, 1000, 0.03)
    with open(os.path.join(d, "index.log"), "w") as e, \
            contextlib.redirect_stderr(e):
        cli.main(["index", fa])
    sets = {"1kb": (fa, next(iter(load_read_batches(fq, 2048,
                                                    background=False))))}
    for k, (name, n, read_len) in enumerate((("10kb", 200, 10_000),
                                             ("50kb", 40, 50_000))):
        reads, _, _ = smoke.make_long_reads(g, seed + 1 + k, n, read_len)
        sets[name] = (fa, reads)
    rfa, rreads = smoke.repeat_genome(d, seed)
    sets["repeat"] = (rfa, rreads)
    out = {}
    for name, (f, reads) in sets.items():
        index = load_device_index(f, "cuda", verbose=False)
        cfg, codes, lens = smoke.vote_chunk(
            index, reads, smoke.VOTE_SETS.get(name, 1024))
        want = None
        for tag in libs:                        # warm-up and bit-equality
            with using("vote", load(libs[tag], VOTE_FUNCS)):
                tabs = seed_tables(cfg, index[0], codes, lens)
            if want is None:
                want = tabs
            elif not all(torch.equal(a, b) for a, b in zip(tabs, want)):
                raise AssertionError(f"seed_tables {tag} differs at {name}")
        out[name] = traced_turns(
            libs, VOTE_FUNCS, "vote", "seed_tables_kernel",
            lambda: seed_tables(cfg, index[0], codes, lens), rounds)
        print(f"[sweep] seed_tables {name} (B {cfg.B}, {int(want[3].sum())} "
              f"wide): {json.dumps(out[name])}", flush=True)
        del index
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="walk_c,gact_walk,seed_tables",
                    help="the kernels to sweep, comma-separated")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_walk_tables_sweep.py needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[sweep] {card}", flush=True)
    jobs = {}
    if "walk_c" in parts:
        jobs.update({f"walkc_l{n}_a{a}_g{g}": ("walk", dict(
            kWalkLanes=n, kWalkAhead=a, kWalkRing=ring(a), kWalkGroups=g))
            for n, a, g in WALK_C_VARIANTS})
    if "gact_walk" in parts:
        jobs.update({f"walk_w{w}_l{n}_a{a}": ("walk", dict(
            kGactWarps=w, kGactLanes=n, kAhead=a, kRing=ring(a)))
            for w, n, a in WALK_VARIANTS})
    if "seed_tables" in parts:
        jobs.update({f"tables_t{t}_s{s}": ("vote", dict(
            kSeedThreads=t, kSeedsPerThread=s)) for t, s in TABLE_VARIANTS})
    out = dict(card=card)
    with tempfile.TemporaryDirectory(prefix="lrm_sweep_") as d:
        libs = build_variants(d, jobs)

        def of(prefix):
            return {k: v for k, v in libs.items() if k.startswith(prefix)}
        if "walk_c" in parts:
            out["walk_c"] = sweep_walk_c(np.random.default_rng(args.seed),
                                         of("walkc_"), args.rounds)
        if "gact_walk" in parts:
            out["gact_walk"] = sweep_walk(np.random.default_rng(args.seed),
                                          of("walk_"), args.rounds)
        if "seed_tables" in parts:
            out["seed_tables"] = sweep_tables(d, args.seed, of("tables_"),
                                              args.rounds)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
