#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (longreadmapper_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each to its plain
PyTorch version, drives `cli index` + `cli map` on a bacterial-scale
reference with 1 kb, 10 kb and 50 kb reads, checks the SAM, breaks the
mapping step's time down by stage, maps the same reads in every index
layout, builds the index's suffix array by blocks on disk and on the
card, scores the reads with the affine aligner, maps through `cli
mapdist` (world 1) and after `cli warmup`, and drives the host tools (the
FM-index queries, `TorchMapper.map_stream`, the Myers aligners).

  python3 chip_smoke.py [--seed N]

Phases (each raises on failure; nothing is caught):
  1. device  — requires CUDA; prints the card's name and power limit
  2. build   — nvcc builds csrc/band_dp.cu, csrc/band_scores.cu,
               csrc/walk.cu, csrc/vote.cu and csrc/step.cu for sm_90a and
               g++ the host
               code (the
               suffix-array build csrc/sais.cpp, the external build's
               merge csrc/samerge.cpp,
               the affine traceback csrc/affine.cpp, the banded aligner
               csrc/align.cpp, the Myers distance csrc/myers.cpp), from
               this checkout,
               one compiler each, in parallel, and prints each kernel's
               registers, stack and spills
  3. kernel  — each kernel against its plain version on the card,
               bit-equal at every listed shape; median times at the main
               shapes: band_dp (warp per read, at bands 128-512;
               band_dp_wide timed beside it; the step takes the warp
               kernel at ops/band_dp.BANDS), band_dp_wide (resident, one
               tile,
               and every tile of each gact pass of the main path: 50 kb
               at band 5120 and 10112, the 10 kb retry at band 2176,
               entered from the plain forward pass's checkpoints),
               band_scores (the checkpoints of those passes at one CTA a
               read and at the card's cluster size, and of an 8192-row
               pass, held to the plain forward pass, and the full
               matrix); then, in turns in one loop, each gact pass's
               tiles in the walk's groups against single-tile launches,
               its checkpoints at each C (the card's choice,
               ops/band_scores.cluster_ctas, beside C = 1), and the 10 kb
               resident pass; then the walks, each bit-equal to its plain
               walk (runs and the saturated flag): walk_c on band_dp's
               words at the 1 kb main shape and on band_dp_wide's at the
               10 kb resident shape (int32 entries), and on random words;
               gact_walk over every tile group of the 50 kb pass at band
               5120 and of the 10 kb retry at band 2176, and on a weave
               that saturates its buffer at scale 1; CUDA-event medians
               of kernel and plain walk, the longest lane's iterations and
               the kernel's ns an iteration (walk_c: also the kernel alone
               from a torch.profiler trace); the gact walk's iterations a
               tile held to the plain walk's, their per-tile maxima (the
               lock-step walk's block iterations) beside the longest
               lane's
  3b. vote   — after phase 4, whose index and reads it takes: the seed
               vote's kernels (seed_tables; vote_rows, the wide seeds'
               pick, the vote rows and each read's accept in one launch,
               its (best, overflow) and every row's outputs; and
               top2_votes on the rows' votes) each bit-equal to its plain
               version at the 1 kb, 10 kb and 50 kb buckets (B 2048, 200,
               40), in the four index layouts, in the compact and exact
               tiers; rows of C 20096 in global scratch at 50 kb; on a
               repeat genome whose seeds are wide and whose rows pass C;
               CUDA-event medians of vote_rows and its plain versions in
               every case, of each kernel at each bucket (full int32
               layout), beside the bound
  3c. glue   — after 3b, on the same chunks: the step glue's four kernels
               (csrc/step.cu: encode, locate_window, lanes, pack) each
               bit-equal to its plain version at the 1 kb, 10 kb and 50 kb
               buckets, in the full int32 and full pos64 layouts, on the
               values the step hands it (the raw chunk, the seed vote's
               best, the DP's centre column, the walk's run entries);
               CUDA-event medians of each wrapper and its plain version,
               and each kernel alone from a torch.profiler trace, beside
               the bound
  4. map     — a 4 Mb single-contig genome and 16384 1 kb reads (3%
               substitutions, both strands, planted positions), all made
               from --seed; `cli index` (the lchash built on the card, held
               byte for byte to the host build from the suffix array, both
               timed, and the card build timed at four batch sizes) then
               `cli map` in-process; checks record count, validity,
               placement, that every CIGAR consumes its read and spells its
               ED against the genome, that every chunk was encoded on the
               card (raw bytes in), and that the main path went through
               the kernels (the seed vote's two, the DP, the walk and the
               step glue's four) and never through a plain version, with
               no walk host sync; the
               dispatch and fetch seconds a chunk
  5. cpu     — `cli map --device cpu` (plain versions, in subprocesses
               that run beside phases 6 and 7 and are checked after them)
               and `--device cuda` give byte-identical SAM, both through
               the device read encode: the first 256 1 kb reads, 16 reads
               of the 10 kb set (2 high-error, so the full-band retry runs
               through gact at band 2176) and 2 reads of the 50 kb set
  6. stages  — per-stage times of the mapping step on the 1 kb reads and
               a torch.profiler trace of its device kernels, with the seed
               vote by its kernels and by its plain versions; then one
               step under torch.cuda.set_sync_debug_mode("error"), which
               raises at any op that waits for the card
  7. long    — 800 reads of 10 kb and 160 of 50 kb on the phase-4 genome
               (3% substitutions + 0.5% 1-base insertions + 0.5% deletions;
               2% of the reads at 7% + 1%, past the half band), each set
               through `cli map --device cuda --chunk-b 2048`; checks as
               phase 4 plus the bucket configs, the bit-2 retries and the
               long-read kernels' launches (at 50 kb, fewer multi-tile
               launches a gact pass than its 98 tiles; the seed vote's
               and the walks' kernels, no plain seed vote or walk, no walk
               host sync); then per-stage times as phase 6, the 10 kb step
               under the sync debug mode "error", the 50 kb step under
               "warn" (each sync it makes is logged)
  8. layouts — the phase-4 reads (16384 1 kb, and phase 5's 10 kb and 50
               kb reads) in the slim layout through `cli map --slim-index`
               (served by deriving from the full cache) and in every layout
               in-process (full and slim, int32 and forced pos64
               positions): each SAM byte-identical to the full int32
               layout's; per layout the index tables' device bytes, bytes
               per position without the lchash (within 2% of 9.5 / 6.0 /
               10.5 / 7.0), the 1 kb map's reads/s, the seed_vote stage's
               ms and the largest genome the card would hold (computed)
  9. index   — on the phase-4 genome: `cli index --ram-gb G` (G for about
               EXT_BLOCKS blocks; the external suffix-array build and its
               native merge) on a copy of the FASTA, its five artifacts and
               devidx cache byte-identical to phase 4's, its sa_build stage
               beside phase 4's; `sa_build_device` (prefix doubling on the
               card) on the phase-4 .cat, equal to phase 4's .sa5, and on a
               random .cat of 2^27 - 1 codes (a 67 Mb genome and its
               reverse complement), equal to the host SA-IS, each timed
               with its rounds and peak device memory; `banded_sw_affine`
               at the 1 kb main shape on the first 2048 1 kb reads against
               their planted windows, bit-equal to the same call on the
               CPU, its score and ends equal to `affine_align` for 64
               reads, timed
  10. dist   — `cli mapdist` at world 1 (one NCCL rank, its group formed
               and destroyed by the command) on the phase-4 reads, with the
               index replicated and with `--shard-index` (the six gather
               tables as ShardedRows: a masked gather and an NCCL
               all_reduce a table): each .part0 byte-identical to phase 4's
               SAM, the global valid count equal to phase 4's; the first
               N_DIST_LONG 10 kb reads through the mesh's full-band gact
               pass, checked as phase 4 and compared with phase 7's SAM;
               the seed vote's stage times over the sharded and the
               replicated tables; and the first chunk's dispatch seconds
               of `cli map` in a fresh process, cold and after `cli warmup
               --lengths 1024`, each SAM equal to phase 4's
  11. tools  — on the phase-4 genome, index and reads: `sa_load` against
               the FM-index's SA; `csa_access` against the SA on
               N_TOOL_ROWS random rows; `fmi_aln` of N_TOOL_ROWS hlen-mers
               of the genome and as many random ones against the .lch
               that phase 4 built on the card; the lchash lookup plus
               `fmi_aln` against `fmi_aln` alone on queries of 20-32
               bases; `TorchMapper.map_stream` on the card, its records
               equal to phase 4's SAM lines and its band_dp launches to
               phase 4's, its reads/s beside `map_stream_sam`'s; every
               valid record rescored by `native.myers_distance` (NW over
               its reference span, at most its ED) and
               `native.myers_align` (HW in a window 64 bases wider each
               side, k = ED, its path checked as phase 4's CIGARs)

The last stdout line is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that the kernels'
JSON record: per kernel its main-path launches, its largest |diff| against
the plain version, its time, the plain version's, and the bound (for a
DP the larger of its bytes at 3.35 TB/s and its int32 operations,
INT_OPS_CELL a cell, at INT32_OPS_S; for a walk the words it gathers,
WALK_WORD_BYTES a lane-iteration, and its entries, at 3.35 TB/s;
for the seed vote the larger of its bytes (each gathered row once) and
its int32 operations, vote_bounds; for the step glue its bytes, each
input read once and each output written once, glue_bounds; library_ms
null: no PyTorch call computes a banded NW DP, its walk, the seed vote or
any of the glue's four functions).
Phases 4, 7, 10 and 11 check on each map that the seed vote, the walks
and the step glue launched their kernels (the raw encode wherever a chunk
ships raw bytes: the mesh of phase 10's mapdist ships host codes, as
JAX's does), called no plain version of them on the card and made no
walk host sync.
Exits non-zero, printing no result, when CUDA is unavailable or the
port's package is not beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_SHAPE = (2048, 1024, 102, 256)            # B, L, W, band of 1 kb reads
SHAPES = (MAIN_SHAPE, (37, 128, 12, 128), (64, 2048, 204, 512),
          (680, 3072, 153, 384))               # the 3072 bucket's first pass
WIDE_MAIN = (200, 10240, 512, 1152)            # the 10 kb resident pass
WIDE_SHAPES = (WIDE_MAIN, (37, 4096, 409, 896), (16, 2048, 1024, 2176))
TILE_B, TILE_L, TILE_T, TILE_K = 40, 8192, 512, 8   # entry row ckpt[8]
TILE_BANDS = ((2508, 5120), (5017, 10112))     # 50 kb first pass, retry
PASS_SHAPES = ((40, 50176, 2508, 5120),        # a 50 kb gact pass: 98 tiles
               (40, 50176, 5017, 10112),       # its full-band retry
               (200, 10240, 1024, 2176))       # the 10 kb retry: 20 tiles
DIRS_BUDGET = 1 << 30                          # MapperConfig.mid_dirs_budget
TURNS = 5                                      # rounds of the timing turns
# the bound: HBM at 3.35 TB/s; int32 at 132 SMs x 64 lanes x 1.98 GHz =
# 16.7 Tops/s (half the lanes of the 67 TFLOP/s float32 rate of the
# on-chip guide's table, which counts an FMA as 2); a dozen int32 ops a
# DP cell (sub, a, up1, two mins, slope, prefix, +d, mask, clamp, dir)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
INT_OPS_CELL = 12
SCORES_1KB = (128, 1024, 102, 256)             # wavefront_pallas.py:6-8
# the walks: the column walk at the 1 kb main shape (int16 entries) and at
# the 10 kb resident shape (int32), the gact walk over every group of the
# 50 kb pass at band 5120 and of the 10 kb retry at 2176 (PASS_SHAPES), on
# reads with make_long_reads' indel share; a weave whose run buffer
# saturates at scale 1 (B, L, T, W, band, C: C bases inserted at every
# even tile start, C deleted at every odd one); walk_c on random words
WALK_INDEL = 0.01
WALK_SATURATE = (40, 8192, 512, 64, 256, 48)
WALK_RANDOM = (2048, 1024, 102, 256)
WALK_WORD_BYTES = 12               # current, bitmap, target word a step
SCORES_SHAPES = (SCORES_1KB, (40, 4096, 2508, 5120))
N_READS = 16384                                # phase 4: 8 chunks of 2048
N_CPU_READS = 256                              # phase 5, 1 kb reads
N_STAGE_READS = 8192                           # phase 6: 1 warm-up + 3 chunks
# phase 7 sets: name -> (reads, read length, the bucket config expected:
# L, B, path, W, band, run-entry bytes); every HI_EVERY-th read is
# high-error; phase 5 maps the reads of CPU_LONG on both devices (10 kb:
# 2 high-error reads and 14 others; 50 kb: 2 low-error reads)
LONG_SETS = {
    "10kb": (800, 10_000, dict(L=10240, B=200, path="resident", W=512,
                               band=1152, entry_bytes=4)),
    "50kb": (160, 50_000, dict(L=50176, B=40, path="gact", W=2508,
                               band=5120, entry_bytes=2)),
}
HI_EVERY = 50
CPU_LONG = {"10kb": [0, HI_EVERY] + list(range(1, 15)), "50kb": [1, 2]}
# each CPU map's threads per 8 cores: the 50 kb set's plain gact DP is the
# longest, the 1 kb set ends in seconds; a core stays with the card's work
CPU_THREADS = {"1kb": 1, "10kb": 2, "50kb": 4}
# phase 8: the index layouts, their load_device_index arguments and the
# device bytes a position each should take without the lchash (counted
# from the tables: sa_ctx 8 or 4, sa_hi 1, packed + text_packed 0.5,
# occ_samp 1, text_pair 0.5)
LAYOUTS = {"full int32": ({}, 9.5), "slim int32": (dict(slim=True), 6.0),
           "full pos64": (dict(force_pos_dtype="int64"), 10.5),
           "slim pos64": (dict(force_pos_dtype="int64", slim=True), 7.0)}
LCH_CHUNKS = (1 << 20, 1 << 22, 1 << 24, 1 << 26)   # phase 4's batch sizes
EXT_BLOCKS = 8                     # phase 9: blocks of the external build
BIG_SA_GENOME = (1 << 26) - 1      # phase 9: a .cat of 2^27 - 1 codes
N_AFFINE_ALIGN = 64                # phase 9: reads held to affine_align
N_DIST_LONG = 200                  # phase 10: the first reads of the 10 kb set
N_TOOL_ROWS = 4096                 # phase 11: SA rows and k-mers queried
# phase 3b: the seed vote's kernels at each set's bucket (L; B follows
# from --chunk-b 2048), in every layout (LAYOUTS) and tier; a repeat genome
# (random bases, then motif A of REPEAT_A[0] bases REPEAT_A[1] times, whose
# seeds are wide, then motif B likewise, whose seeds are not wide but vote
# ~150 times each, so rows pass C) and its 1 kb reads, a quarter from
# each motif run
VOTE_SETS = {"1kb": 1024, "10kb": 10240, "50kb": 50176}
REPEAT_GENOME, REPEAT_A, REPEAT_B = 600_000, (60, 400), (64, 150)
VOTE_TURNS = 20                    # timed calls of each kernel
VOTE_GLOBAL_C = 20000              # a budget whose rows pass 227 KB
# phase 3c: the step glue's kernels at each set's bucket in these layouts
GLUE_LAYOUTS = ("full int32", "full pos64")
GLUE_KERNELS = ("encode", "locate_window", "lanes", "pack")
GLUE_TURNS = 50                    # timed calls of each wrapper and kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: "
                           "this smoke needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


def phase_build():
    from longreadmapper_tpu_torch import native_build
    native_build.build(force=True)
    for name, info in native_build.build_info.items():
        log(f"[2 build] {info['tool']} csrc/{native_build.SOURCES[name][0]} "
            f"in {info['seconds']} s")
        kernel = None
        for line in info["report"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif "registers" in line or "stack frame" in line:
                log(f"[2 build]   {kernel}: {line.strip()}")


def dp_inputs(rng, B: int, L: int, indel: float = 0.0):
    """Reads mutated from seeded targets (3% substitutions, a few 1-base
    indels, or a share `indel` of the bases when given, ragged ends), plus
    all-pad rows; as CUDA tensors."""
    import numpy as np
    import torch
    t = rng.integers(0, 4, (B, L)).astype(np.int8)
    q = np.full((B, L), 4, np.int8)
    for b in range(B):
        s = t[b].copy()
        m = rng.random(L) < 0.03
        s[m] = (s[m] + 1 + rng.integers(0, 3, int(m.sum()))) % 4
        s = list(s)
        for _ in range(int(rng.binomial(L, indel)) if indel
                       else int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(s) - 1))
            if rng.random() < 0.5:
                del s[p]
            else:
                s.insert(p, int(rng.integers(0, 4)))
        n = min(len(s), L - int(rng.integers(0, L // 8)))
        q[b, :n] = s[:n]
        t[b, n + int(rng.integers(0, 4)):] = 5
    q[::97] = 4                                   # pad rows
    t[::97] = 5
    return torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()


def cuda_ms(fn, reps: int) -> float:
    """Median per-call ms by CUDA events, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def trace_ms(fn, kernel: str, calls: int, tries: int = 3) -> float:
    """Median device ms of a launch of the kernel named `kernel` over
    `calls` calls of fn (one launch each), from a torch.profiler trace
    after a warm-up call. The profiler now and then drops a launch's
    record, so a trace that holds fewer than `calls` launches is taken
    again, up to `tries` traces, and the last one is used if none holds
    them all. Raises if a trace holds more launches than were made, or
    if no trace holds any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        t = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type.name == "CUDA" and kernel in e.name]
        if len(t) > calls:
            raise AssertionError(f"{len(t)} {kernel} launches traced, "
                                 f"{calls} made")
        if len(t) == calls:
            break
        log(f"[trace] {len(t)} of {calls} {kernel} launches traced")
    if not t:
        raise AssertionError(f"no {kernel} launch traced in {tries} traces "
                             f"of {calls} calls")
    return statistics.median(t)


def turns(fns: dict, rounds: int) -> dict:
    """Median ms of each of `fns` ({name: fn}), timed in turns: one warm-up
    call each, then `rounds` rounds that call each once, in order on even
    rounds and in reverse on odd ones, each timed by CUDA events."""
    import torch
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def bound(cells: int, nbytes: int):
    """(bound_ms, bound_by): the least time of a DP over `cells` cells that
    reads and writes `nbytes`, the larger of its operations (INT_OPS_CELL
    int32 ops a cell at INT32_OPS_S) and its bytes (at HBM_BYTES_S)."""
    ops_ms = cells * INT_OPS_CELL / INT32_OPS_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def dirs_bound(B: int, L: int, band: int, n: int, tiles: int = 1):
    """bound() of `tiles` direction tiles of n rows of reads of length L
    (a whole pass: n = L): q and t once, the entry rows, the words, the nm
    bitmap and the centre column."""
    G = n // 16
    nbytes = (2 * B * L + 4 * B * band * tiles
              + 4 * B * band * (G + -(-G // 32)) * tiles
              + 2 * B * (n + 1) * tiles)
    return bound(B * n * band * tiles, nbytes)


def ckpt_bound(B: int, L: int, band: int, T: int):
    """bound() of the gact forward pass: q and t once, the checkpoint rows
    and the centre column."""
    return bound(B * L * band, 2 * B * L + 4 * B * band * (L // T + 1)
                 + 2 * B * (L + 1))


def timed_once(fn):
    """(fn(), its ms by CUDA events): one call of a plain version that
    takes seconds, used both as the reference and as its time."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def check_equal(kernel: str, where: str, got, want,
                tag: str = "3 kernel") -> int:
    """Raise unless every output is bit-equal; returns the max |diff|."""
    import torch
    torch.cuda.synchronize()
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{kernel} output {i} {tuple(g.shape)} "
                                 f"{g.dtype} vs {tuple(w.shape)} {w.dtype}")
        diff = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        err = max(err, diff)
        if not torch.equal(g, w):
            raise AssertionError(f"{kernel} output {i} differs from the "
                                 f"plain version at {where} (max |diff| "
                                 f"{diff})")
    log(f"[{tag}] {kernel} {where}: bit-equal to the plain version")
    return err


def phase_kernel(seed: int) -> dict:
    import numpy as np
    from longreadmapper_tpu_torch.ops.band_dp import (
        BANDS, _band_dp, band_dp_tiles, banded_nw_dirs,
        banded_nw_dirs_tiles_v)
    from longreadmapper_tpu_torch.ops.band_scores import (
        band_checkpoints, band_scores, card_resident, cluster_ctas,
        resident_clusters)
    from longreadmapper_tpu_torch.ops.gact import (gact_forward,
                                                   gact_group_tiles)
    from longreadmapper_tpu_torch.ops.wavefront import (banded_nw_dirs_v,
                                                        banded_nw_scores,
                                                        row0)

    import torch
    rng = np.random.default_rng(seed)
    resident = card_resident(0)
    log(f"[3 kernel] clusters the card holds at once, one CTA an SM "
        f"(cudaOccupancyMaxActiveClusters): {json.dumps(resident)}")
    res = {k: dict(err=0, ms=None, plain_ms=None, bound_ms=None,
                   bound_by=None)
           for k in ("band_dp", "band_dp_wide", "band_scores", "walk_c",
                     "gact_walk")}

    def note(kernel, where, ms, plain_ms, bnd=None):
        """Log a kernel's time; with its bound, it is the kernels line's."""
        log(f"[3 kernel] {kernel} {where} median: kernel {ms} ms, plain "
            f"PyTorch {plain_ms} ms ({plain_ms / ms}x)")
        if bnd is not None:
            log(f"[3 kernel] {kernel} {where} bound {bnd[0]} ms by "
                f"{bnd[1]} ({bnd[0] / ms:.4f} of it reached)")
            res[kernel].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                               bound_by=bnd[1])

    def err(kernel, e):
        res[kernel]["err"] = max(res[kernel]["err"], e)

    def wide_pass(q, t, W, band):
        """band_dp_wide over a whole pass: one tile of L rows from row 0."""
        B, L = q.shape
        h0 = row0(B, L, W, band, q.device)[None]
        return [x[0] for x in band_dp_tiles(q, t, W, band, h0, L, 0, 1)]

    # band_dp, the warp-per-read kernel, at its four bands; band_dp_wide,
    # which takes these bands too, on the same inputs and timed beside it
    # (banded_nw_dirs takes the warp kernel at BANDS, the wide one above)
    for B, L, W, band in SHAPES:
        q, t = dp_inputs(rng, B, L)
        where = f"B={B} L={L} W={W} band={band}"
        n0 = banded_nw_dirs.launches
        got = _band_dp(q, t, W, band)
        assert banded_nw_dirs.launches == n0 + 1
        want = banded_nw_dirs_v(q, t, W, band)
        err("band_dp", check_equal("band_dp", where, got, want))
        err("band_dp_wide", check_equal("band_dp_wide", where,
                                        wide_pass(q, t, W, band), want))
        del got, want
        ms = cuda_ms(lambda: _band_dp(q, t, W, band), 20)
        wide_ms = cuda_ms(lambda: wide_pass(q, t, W, band), 20)
        log(f"[3 kernel] {where} median: band_dp {ms} ms, band_dp_wide "
            f"{wide_ms} ms ({wide_ms / ms}x); the step takes "
            f"{'band_dp' if band in BANDS else 'band_dp_wide'}")
        if (B, L, W, band) == MAIN_SHAPE:
            note("band_dp", where, ms,
                 cuda_ms(lambda: banded_nw_dirs_v(q, t, W, band), 3),
                 dirs_bound(B, L, band, L))

    # band_dp_wide, resident: the whole pass from row 0 (band_dp_tiles,
    # one tile)
    timed = {}
    for B, L, W, band in WIDE_SHAPES:
        q, t = dp_inputs(rng, B, L)
        where = f"resident B={B} L={L} W={W} band={band}"
        n0 = band_dp_tiles.launches
        got = banded_nw_dirs(q, t, W, band)
        assert band_dp_tiles.launches == n0 + 1
        want, plain_ms = timed_once(lambda: banded_nw_dirs_v(q, t, W, band))
        err("band_dp_wide", check_equal("band_dp_wide", where, got, want))
        del got, want
        if (B, L, W, band) == WIDE_MAIN:
            timed["resident 10 kb"] = (
                lambda q=q, t=t, W=W, band=band: banded_nw_dirs(q, t, W,
                                                                band),
                plain_ms, dirs_bound(B, L, band, L))

    # band_scores checkpoints at PR 2's timing shape, and one band_dp_wide
    # tile entered from the plain forward pass's checkpoint row TILE_K
    B, L, T = TILE_B, TILE_L, TILE_T
    for W, band in TILE_BANDS:
        q, t = dp_inputs(rng, B, L)
        where = f"checkpoints B={B} L={L} W={W} band={band} T={T}"
        want, plain_ms = timed_once(lambda: gact_forward(q, t, T, W, band))
        err("band_scores", check_equal(
            "band_scores", where, band_checkpoints(q, t, T, W, band), want))
        if (W, band) == TILE_BANDS[0]:      # the 8192-row checkpoint shape
            timed["checkpoints 8192"] = (
                lambda q=q, t=t, W=W, band=band: band_checkpoints(
                    q, t, T, W, band),
                plain_ms, ckpt_bound(B, L, band, T))
        ckpt, i0 = want[0], TILE_K * T
        where = f"tile B={B} L={L} W={W} band={band} rows {i0}+{T}"
        n0 = band_dp_tiles.launches
        got = [x[0] for x in band_dp_tiles(q, t, W, band, ckpt, T, TILE_K,
                                           1)]
        assert band_dp_tiles.launches == n0 + 1
        want_t, plain_ms = timed_once(
            lambda: banded_nw_dirs_v(q, t, W, band, h0=ckpt[TILE_K], i0=i0,
                                     n=T))
        err("band_dp_wide", check_equal("band_dp_wide", where, got, want_t))
        note("band_dp_wide", where, cuda_ms(
            lambda: band_dp_tiles(q, t, W, band, ckpt, T, TILE_K, 1), 10),
            plain_ms)
        del want, got, want_t, ckpt

    # every gact pass of the main path at its shape: band_scores's
    # checkpoints at one CTA a read and at the card's cluster size (all
    # sizes: scripts/torch_cluster_sweep.py) held to the plain forward pass,
    # then the multi-tile entry over all the pass's tiles entered from the
    # plain checkpoints; then the pass as the walk runs it (groups of
    # gact_group_tiles, newest first) and as single-tile launches
    chosen = {}
    for B, L, W, band in PASS_SHAPES:
        K = L // T
        q, t = dp_inputs(rng, B, L)
        name = f"{L // 1000} kb band {band}"
        want, ck_plain_ms = timed_once(lambda: gact_forward(q, t, T, W,
                                                            band))
        chosen[name] = cluster_ctas(B, band, resident)
        for C in sorted({1, chosen[name]}):
            where = f"checkpoints B={B} L={L} W={W} band={band} T={T} C={C}"
            err("band_scores", check_equal(
                "band_scores", where,
                band_checkpoints(q, t, T, W, band, ctas=C), want))
            timed[f"checkpoints {name} C{C}"] = (
                lambda q=q, t=t, W=W, band=band, C=C: band_checkpoints(
                    q, t, T, W, band, ctas=C), ck_plain_ms,
                ckpt_bound(B, L, band, T))
        C = chosen[name]
        log(f"[3 kernel] band_scores {name} B={B}: cluster_ctas -> C={C}"
            + (f", {resident_clusters(B, band, C)} clusters resident at "
               "once (cudaOccupancyMaxActiveClusters)" if C > 1 else ""))
        ckpt = want[0]
        del want
        where = f"tiles B={B} L={L} W={W} band={band} T={T} x{K}"
        n0 = band_dp_tiles.launches
        got = band_dp_tiles(q, t, W, band, ckpt, T, 0, K)
        assert band_dp_tiles.launches == n0 + 1
        want, plain_ms = timed_once(
            lambda: banded_nw_dirs_tiles_v(q, t, W, band, ckpt, T, 0, K))
        err("band_dp_wide", check_equal("band_dp_wide", where, got, want))
        del got, want
        group = gact_group_tiles(B, L, T, band, DIRS_BUDGET)

        def grouped(q=q, t=t, ckpt=ckpt, W=W, band=band, group=group, K=K):
            k_hi = K - 1
            while k_hi >= 0:
                k_lo = max(0, k_hi - group + 1)
                band_dp_tiles(q, t, W, band, ckpt, T, k_lo, k_hi - k_lo + 1)
                k_hi = k_lo - 1

        def singles(q=q, t=t, ckpt=ckpt, W=W, band=band, K=K):
            for k in range(K - 1, -1, -1):
                band_dp_tiles(q, t, W, band, ckpt, T, k, 1)

        timed[f"tiles {name} grouped by {group}"] = (
            grouped, plain_ms, dirs_bound(B, L, band, T, K))
        timed[f"tiles {name} single x{K}"] = (
            singles, plain_ms, dirs_bound(B, L, band, T, K))

    ms = turns({k: v[0] for k, v in timed.items()}, TURNS)
    log(f"[3 kernel] in turns ({TURNS} rounds): " + json.dumps(ms))
    for name, (_, plain_ms, bnd) in timed.items():
        log(f"[3 kernel] {name}: {ms[name]} ms, bound {bnd[0]} ms by "
            f"{bnd[1]} ({bnd[0] / ms[name]:.4f} of it reached), plain "
            f"{plain_ms} ms")
    for name, C in chosen.items():
        one = ms[f"checkpoints {name} C1"]
        best = ms[f"checkpoints {name} C{C}"]
        log(f"[3 kernel] band_scores {name}: C={C} {best} ms against C=1 "
            f"{one} ms ({best / one:.4f}x)")
    # the kernels line: the 50 kb first pass as the step launches it, its
    # tiles in the walk's groups and its checkpoints at cluster_ctas's C
    main = f"{PASS_SHAPES[0][1] // 1000} kb band {PASS_SHAPES[0][3]}"
    tiles = next(k for k in timed if k.startswith(f"tiles {main} grouped"))
    note("band_dp_wide", "pass " + tiles, ms[tiles], timed[tiles][1],
         timed[tiles][2])
    ck = f"checkpoints {main} C{chosen[main]}"
    note("band_scores", "pass " + ck, ms[ck], timed[ck][1], timed[ck][2])
    del timed

    # band_scores, the full score matrix
    for B, L, W, band in SCORES_SHAPES:
        q, t = dp_inputs(rng, B, L)
        where = f"full B={B} L={L} W={W} band={band}"
        got = band_scores(q, t, W, band)
        want, plain_ms = timed_once(lambda: banded_nw_scores(q, t, W, band))
        err("band_scores", check_equal("band_scores", where, [got], [want]))
        del got, want
        if (B, L, W, band) == SCORES_1KB:
            ms = cuda_ms(lambda: band_scores(q, t, W, band), 20)
            note("band_scores", where, ms,
                 cuda_ms(lambda: banded_nw_scores(q, t, W, band), 3))
            # q and t once, H (L+1, B, band) int16 once
            bnd = bound(B * L * band, 2 * B * L + 2 * (L + 1) * B * band)
            log(f"[3 kernel] band_scores {where} bound {bnd[0]} ms by "
                f"{bnd[1]} ({bnd[0] / ms:.4f} of it reached)")
    phase_walks(rng, res)
    return res


def walk_stats(runs, B: int) -> tuple:
    """(lane-iterations, the longest lane's iterations, the block's
    iterations) of a walk's runs: an iteration of a live lane writes at
    least one entry that is not a pad."""
    live = ((runs.reshape(B, -1, 2) & 3) != 3).any(dim=2)
    return (int(live.sum()), int(live.sum(dim=1).max()),
            int(live.any(dim=0).sum()))


def walk_bound(lane_iters: int, runs):
    """(bound_ms, "bytes"): the words the walk must gather (WALK_WORD_BYTES
    a lane-iteration) and its entries written once, at HBM_BYTES_S."""
    nbytes = lane_iters * WALK_WORD_BYTES + runs.numel() * runs.element_size()
    return nbytes / HBM_BYTES_S * 1e3, "bytes"


def gact_walk_ms(fn, q, t, ckpt, lens, T, W, band, scale, group,
                 iters=None):
    """(runs, saturated, ms): one call of gact_traceback_c or its plain
    version with a CUDA event at each mark; ms sums each group's span from
    its rematerialized words ("dirs") to the end of its walk ("walk").
    `iters` as gact_traceback_c's (each lane's iterations a tile)."""
    import torch
    evs = []

    def mark(stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        evs.append(e)

    runs, sat = fn(q, t, ckpt, lens, T, W, band, scale, group, mark,
                   iters=iters)
    torch.cuda.synchronize()
    return runs, sat, sum(a.elapsed_time(b)
                          for a, b in zip(evs[::2], evs[1::2]))


def weave_inputs(B: int, L: int, T: int, C: int, rng):
    """The saturation weave of tests/test_torch_gact.py: C random bases
    inserted at every even tile start and C deleted at every odd one, so
    the path pays about C indel rows in every tile; as CUDA tensors."""
    import numpy as np
    import torch
    qs = rng.integers(0, 4, 2 * L).astype(np.int8)
    parts, i = [], 0
    for k in range(L // T):
        if k % 2 == 0:
            parts.append(rng.integers(0, 4, C).astype(np.int8))
            parts.append(qs[i:i + T - C])
            i += T - C
        else:
            i += C
            parts.append(qs[i:i + T])
            i += T
    q = np.broadcast_to(qs[:L], (B, L)).copy()
    t = np.broadcast_to(np.concatenate(parts)[:L], (B, L)).copy()
    return torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()


def walk_lens(q, wcol, W: int):
    """Each read's length (its non-pad query codes), 0 where the DP's
    distance reaches W: the step walks no such lane."""
    import torch
    lens = (q != 4).sum(dim=1).to(torch.int32)
    ed = wcol[lens.long(), torch.arange(q.shape[0], device=q.device)]
    return torch.where(ed.to(torch.int32) < W, lens, 0)


def phase_walks(rng, res: dict) -> None:
    """Phase 3, the walks: walk_c and gact_walk bit-equal to their plain
    walks (same runs, same saturated flag) on the DP kernels' words at the
    main path's shapes, their CUDA-event medians beside the plain walks',
    the longest lane's iterations and the kernel's ns an iteration."""
    import numpy as np
    import torch
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    from longreadmapper_tpu_torch.ops.band_scores import band_checkpoints
    from longreadmapper_tpu_torch.ops.gact import (gact_group_tiles,
                                                   gact_traceback_c,
                                                   gact_traceback_c_plain)
    from longreadmapper_tpu_torch.ops.traceback import (
        device_traceback_c, device_traceback_c_plain)

    def timing(kernel, where, ms, plain_ms, runs, B, lane_iters, longest,
               iters, main):
        if not iters:
            raise AssertionError(f"{kernel} {where}: no lane walked")
        bnd = walk_bound(lane_iters, runs)
        log(f"[3 kernel] {kernel} {where} median: kernel {ms} ms, plain "
            f"PyTorch {plain_ms} ms ({plain_ms / ms}x); {lane_iters} "
            f"lane-iterations, the longest lane {longest}, the block "
            f"{iters}: {ms * 1e6 / iters} ns a block iteration, "
            f"{ms * 1e6 / longest} ns an iteration of the longest lane; "
            f"bound {bnd[0]} ms by bytes ({bnd[0] / ms:.4f} of it "
            "reached)")
        if main:
            res[kernel].update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                               bound_by=bnd[1])

    # walk_c on band_dp's words (1 kb) and band_dp_wide's (10 kb resident)
    for (B, L, W, band), indel, main in ((MAIN_SHAPE, 0.0, True),
                                         (WIDE_MAIN, WALK_INDEL, False)):
        dt = torch.int16 if max(L, band - W) < 8192 else torch.int32
        q, t = dp_inputs(rng, B, L, indel)
        v, wcol, nm = banded_nw_dirs(q, t, W, band)
        lens = walk_lens(q, wcol, W)
        where = (f"B={B} L={L} W={W} band={band} {str(dt)[6:]} entries, "
                 f"{int((lens > 0).sum())} lanes walked")
        n0 = device_traceback_c.launches
        got = device_traceback_c(v, lens, L, W, nm, dt)
        assert device_traceback_c.launches == n0 + 1
        want = device_traceback_c_plain(v, lens, L, W, nm, dt)
        res["walk_c"]["err"] = max(res["walk_c"]["err"], check_equal(
            "walk_c", where, [got], [want]))
        lane_iters, longest, _ = walk_stats(got, B)
        ms = cuda_ms(lambda: device_traceback_c(v, lens, L, W, nm, dt), 20)
        # the kernel alone: the wrapper's event time holds its host time
        kernel_ms = trace_ms(lambda: device_traceback_c(v, lens, L, W, nm,
                                                        dt),
                             "walk_c_kernel", 20)
        plain_ms = cuda_ms(
            lambda: device_traceback_c_plain(v, lens, L, W, nm, dt), 2)
        timing("walk_c", where, ms, plain_ms, got, B, lane_iters, longest,
               longest, main)
        log(f"[3 kernel] walk_c {where}: the kernel alone (trace, median "
            f"of 20) {kernel_ms} ms, {kernel_ms * 1e6 / longest} ns an "
            "iteration of the longest lane")
        del v, nm, got, want

    # walk_c on random words: every lane to its bound, every clamp
    B, L, W, band = WALK_RANDOM
    G = L // 16

    def words(*shape):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).cuda()

    v, nm = words(G, B, band), words(-(-G // 32), B, band)
    lens = torch.from_numpy(rng.integers(-3, L + 40, B).astype(
        np.int32)).cuda()
    for dt in (torch.int16, torch.int32):
        res["walk_c"]["err"] = max(res["walk_c"]["err"], check_equal(
            "walk_c", f"random words B={B} G={G} band={band} {dt}",
            [device_traceback_c(v, lens, L, W, nm, dt)],
            [device_traceback_c_plain(v, lens, L, W, nm, dt)]))
    del v, nm

    # gact_walk over every group of a pass, entered from band_scores's
    # checkpoints, and on the weave that saturates its buffer
    T = 512
    B, L, T2, W, band, C = WALK_SATURATE
    q, t = weave_inputs(B, L, T2, C, rng)
    cases = [(PASS_SHAPES[0], T, 1, True, None), (PASS_SHAPES[2], T, 1,
                                                   False, None),
             ((B, L, W, band), T2, 1, False, (q, t))]
    for (B, L, W, band), T, scale, main, qt in cases:
        q, t = qt or dp_inputs(rng, B, L, WALK_INDEL)
        ckpt, wcol = band_checkpoints(q, t, T, W, band)
        # the weave's distance passes W (C indels a tile): walk it whole
        lens = (walk_lens(q, wcol, W) if qt is None else
                torch.full((B,), L, dtype=torch.int32, device=q.device))
        group = gact_group_tiles(B, L, T, band, DIRS_BUDGET)
        where = (f"B={B} L={L} W={W} band={band} T={T} in groups of "
                 f"{group}, {int((lens > 0).sum())} lanes walked")
        n0 = gact_traceback_c.launches
        iters = torch.empty((L // T, B), dtype=torch.int32, device="cuda")
        iters_p = torch.empty_like(iters)
        got, sat, _ = gact_walk_ms(gact_traceback_c, q, t, ckpt, lens, T, W,
                                   band, scale, group, iters)
        assert gact_traceback_c.launches == n0 + -(-(L // T) // group)
        want, sat_p, _ = gact_walk_ms(gact_traceback_c_plain, q, t, ckpt,
                                      lens, T, W, band, scale, group,
                                      iters_p)
        if sat.dtype != torch.bool or sat.device.type != "cuda" or bool(
                sat) != bool(sat_p):
            raise AssertionError(f"gact_walk saturated {sat} against the "
                                 f"plain walk's {sat_p} at {where}")
        res["gact_walk"]["err"] = max(res["gact_walk"]["err"], check_equal(
            "gact_walk", where + f", saturated {bool(sat)}", [got, iters],
            [want, iters_p]))
        # the lock-step walk pays each tile's slowest lane; the lanes here
        # walk at their own pace
        tile_max = iters.max(dim=1).values
        log(f"[3 kernel] gact_walk {where}: block iterations a tile "
            f"(max over lanes) sum to {int(tile_max.sum())} over "
            f"{int((tile_max > 0).sum())} tiles, the longest lane makes "
            f"{int(iters.sum(dim=0).max())}; per tile "
            f"{tile_max.tolist()}")
        if qt is not None:
            if not bool(sat):
                raise AssertionError("the weave did not saturate the gact "
                                     "walk's buffer at scale 1")
            continue
        lane_iters, longest, block = walk_stats(got, B)
        ms = statistics.median(gact_walk_ms(
            gact_traceback_c, q, t, ckpt, lens, T, W, band, scale, group)[2]
            for _ in range(5))
        plain_ms = statistics.median(gact_walk_ms(
            gact_traceback_c_plain, q, t, ckpt, lens, T, W, band, scale,
            group)[2] for _ in range(2))
        timing("gact_walk", where, ms, plain_ms, got, B, lane_iters, longest,
               block, main)
        del ckpt, got, want


def vote_chunk(index, reads, L: int, exact: bool = False,
               budget: int = 0):
    """(cfg, codes, lens) of the first chunk of `reads` at bucket L, host
    encoded, on the card; the exact tier's config with `exact`, its slots
    at least `budget` with a budget."""
    import torch
    from dataclasses import replace
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.utils.config import Params
    idx, meta, mta = index
    mapper = TorchMapper(idx, meta, mta, Params(), chunk_b=2048,
                         device="cuda")
    cfg = mapper._step_for(L)
    if exact:
        cfg = replace(cfg, exact_slots=True)
    if budget:
        cfg = replace(cfg, vote_budget=budget)
    codes, _, lens, _ = mapper._pack_reads(
        [(n, s, None) for n, s, *_ in reads[:cfg.B]], L, cfg.B)
    return cfg, torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()


def vote_bounds(cfg, tabs, rows_out, keys):
    """(bound_ms, bound_by) of seed_tables, vote_rows and top2_votes on
    this run's data: the larger of the bytes each must move (inputs read
    once, each gathered row once, outputs written once) at HBM_BYTES_S and
    its int32 operations at INT32_OPS_S.  seed_tables: the codes, an lch
    row a seed (and its high bytes), 2 x left occ lookups (a packed word
    and an occ_samp row) a wide seed, its six tables; ~5 ops a code.
    vote_rows: a seed's wide flag, qw and one (k, count) pair, and a wide
    seed's kw, cw and rank besides (the pick needs them for wide seeds
    only); an sa_ctx row (and high byte; a text pair under slim) a vote; a
    row's five outputs and its accept's reads of them, a read's length and
    (best, overflow); a sort's C log2 C compare-and-selects (4 ops) a row.
    top2_votes: a key and a flag a vote, three outputs, the same sort."""
    import math
    qw, k12, cnt12, wide, kw, cw = tabs
    B, L = cfg.B, cfg.L
    N, BP, C = qw.numel(), qw.shape[0], cfg.vote_slots
    pb = 8 if cfg.pos64 else 4
    hi = 2 if cfg.pos64 else 0
    n_wide = int(wide.sum())
    t_bytes = (B * L + 4 * B + N * (8 + hi) + n_wide * 2 * cfg.left * 20
               + N * (4 + pb + 4 + 1 + pb + 4))
    t_ops = N * (5 * cfg.seed_len + 30)
    votes = int(rows_out[3].clamp(max=C).sum())
    row = (4 if cfg.slim else 8) + (1 if cfg.pos64 else 0) + (
        8 if cfg.slim and cfg.left else 0)
    r_bytes = (N * (1 + 4 + pb + 4) + n_wide * (pb + 4 + 4) + votes * row
               + 2 * BP * (13 + pb) + B * (4 + pb + 1))
    sort_ops = BP * C * max(1.0, math.log2(C)) * 4
    k_bytes = keys.numel() * (keys.element_size() + 1) + BP * (8 + pb)
    out = []
    for nbytes, ops in ((t_bytes, t_ops), (r_bytes, sort_ops),
                        (k_bytes, sort_ops)):
        b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
        out.append((b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations"))
    return out


def vote_case(tag: str, where: str, cfg, idx, codes, lens,
              res=None) -> dict:
    """seed_tables, vote_rows (the pick, the vote and the accept, one
    launch) and top2_votes on one chunk, each bit-equal to its plain
    version (vote_rows: (best, overflow) and every row's outputs against
    pick_wide_seeds + vote_rows_plain + seed_accept_plain); CUDA-event
    medians of vote_rows and its plain versions beside the bound, and with
    `res` of all three, into res.  Returns the chunk's counts (wide seeds,
    rows past C, votes) and vote_rows' times."""
    from longreadmapper_tpu_torch.ops.seed_vote import (
        _TICKETS, pick_wide_seeds, seed_tables, seed_tables_plain,
        slot_votes, vote_accept_plain, vote_rows, wide_rank)
    from longreadmapper_tpu_torch.ops.vote import (top2_votes,
                                                   top2_votes_plain)
    errs = {}
    tabs = seed_tables(cfg, idx, codes, lens)
    want = seed_tables_plain(cfg, idx, codes, lens)
    errs["seed_tables"] = check_equal("seed_tables", where, tabs, want, tag)
    qw, k12, cnt12, wide, kw, cw = want
    rank = wide_rank(wide)
    fused = vote_accept_plain(cfg, idx, lens, want, rank)
    best, overflow, rows_p = fused
    got = vote_rows(cfg, idx, lens, want, rank)
    errs["vote_rows"] = max(
        check_equal("vote_rows", where + " (best, overflow)", got[:2],
                    fused[:2], tag),
        check_equal("vote_rows", where + " (rows)", got[2], rows_p, tag))
    if _TICKETS[codes.device].any():
        raise AssertionError(f"{tag}: vote_rows left a read counter set")
    pick = pick_wide_seeds(cfg, wide, k12, cnt12, kw, cw, rank)
    args = (cfg, idx, pick[0], pick[1], qw, wide)
    keys, verified, total = slot_votes(*args)
    top_p = top2_votes_plain(keys, verified)
    errs["top2_votes"] = check_equal("top2_votes", where,
                                     top2_votes(keys, verified), top_p, tag)
    stats = dict(seeds=qw.numel(), rows=qw.shape[0], C=cfg.vote_slots,
                 wide=int(wide.sum()), wide_dropped=int(pick[2].sum()),
                 rows_past_C=int((total > cfg.vote_slots).sum()),
                 votes=int(total.clamp(max=cfg.vote_slots).sum()),
                 verified=int(verified.sum()),
                 overflow_reads=int(overflow.sum()))
    bounds = vote_bounds(cfg, want, rows_p, keys)
    fns = {"seed_tables": (lambda: seed_tables(cfg, idx, codes, lens),
                           lambda: seed_tables_plain(cfg, idx, codes,
                                                     lens)),
           "vote_rows": (lambda: vote_rows(cfg, idx, lens, want, rank),
                         lambda: vote_accept_plain(cfg, idx, lens, want,
                                                   rank)),
           "top2_votes": (lambda: top2_votes(keys, verified),
                          lambda: top2_votes_plain(keys, verified))}
    for (name, (kern, plain)), bnd in zip(fns.items(), bounds):
        if res is None and name != "vote_rows":
            continue
        ms = cuda_ms(kern, VOTE_TURNS)
        plain_ms = cuda_ms(plain, 3)
        if name == "vote_rows":
            stats.update(vote_rows_ms=ms, plain_ms=plain_ms,
                         bound_ms=bnd[0])
        if res is not None:
            log(f"[{tag}] {name} {where} median: kernel {ms} ms, plain "
                f"PyTorch {plain_ms} ms ({plain_ms / ms}x); bound {bnd[0]} "
                f"ms by {bnd[1]} ({bnd[0] / ms:.4f} of it reached)")
            res.setdefault(name, {}).update(
                err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1])
    log(f"[{tag}] {where}: {json.dumps(stats)}")
    return stats


def repeat_genome(d: str, seed: int):
    """Phase 3b's repeat genome, indexed by `cli index` on the card, and
    2048 reads of 1 kb at 3%: a quarter inside each motif run, the rest
    anywhere.  Returns (fa, reads)."""
    import numpy as np
    from longreadmapper_tpu_torch import cli
    rng = np.random.default_rng(seed + 7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    parts = [rng.integers(0, 4, REPEAT_GENOME).astype(np.uint8)]
    runs = []
    for m, copies in (REPEAT_A, REPEAT_B):
        lo = sum(len(p) for p in parts)
        parts.append(np.tile(rng.integers(0, 4, m).astype(np.uint8), copies))
        runs.append((lo, lo + m * copies))
    g = np.concatenate(parts)
    fa = os.path.join(d, "repeat.fa")
    with open(fa, "w") as f:
        s = acgt[g].tobytes().decode()
        f.write(">rep\n" + "\n".join(s[i:i + 70] for i in range(0, len(s),
                                                                   70)) + "\n")
    with open(fa + ".index.log", "w") as e, contextlib.redirect_stderr(e):
        cli.main(["index", fa])
    reads = []
    for i in range(2048):
        lo, hi = (runs[i % 4] if i % 4 < 2 else (0, len(g)))
        p = int(rng.integers(lo, max(lo + 1, hi - 1000)))
        c = g[p:p + 1000].copy()
        m = rng.random(c.shape[0]) < 0.03
        c[m] = (c[m] + 1 + rng.integers(0, 3, int(m.sum()))) % 4
        reads.append((f"q{i}", acgt[c].tobytes().decode()))
    return fa, reads


def phase_vote(d: str, fa: str, fq: str, long_data: dict, seed: int) -> dict:
    """Phase 3b (after phase 4, whose index it reads): the seed vote's
    kernels bit-equal to their plain versions at each set's bucket, in
    every layout and in the compact and exact tiers, on the phase-4 genome
    and on a repeat genome whose rows pass C and whose seeds are wide;
    rows of C 20096 (global scratch) at the 50 kb bucket; CUDA-event
    medians of vote_rows and its plain versions in every case, of all
    three kernels at each bucket in the full int32 layout.  Returns the 1
    kb bucket's numbers, the kernels line's."""
    import gc
    import torch
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch import native_build
    from longreadmapper_tpu_torch.ops.vote import VOTE_FUNCS, pow2_at_least
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches
    tag = "3b vote"
    sets = {"1kb": next(iter(load_read_batches(fq, 2048, background=False)))}
    for name, (reads, _, _) in long_data.items():
        sets[name] = reads
    timed = {}
    vote_ms = {}
    for lname, (load, _) in LAYOUTS.items():
        index = load_device_index(fa, "cuda", verbose=False, **load)
        for name, reads in sets.items():
            for exact in (False, True):
                cfg, codes, lens = vote_chunk(index, reads, VOTE_SETS[name],
                                              exact)
                where = (f"{name} B={cfg.B} L={cfg.L} S={cfg.max_seeds} "
                         f"C={cfg.vote_slots} {lname}"
                         f"{' exact tier' if exact else ''}")
                main = lname == "full int32" and not exact
                out = {} if main else None
                st = vote_case(tag, where, cfg, index[0], codes, lens, out)
                vote_ms[where] = [st["vote_rows_ms"], st["plain_ms"],
                                  st["bound_ms"]]
                if main:
                    timed[name] = out
        if lname == "full int32":
            # rows past the shared-memory limit sort in global scratch, as
            # hg19's exact tier at 10 and 50 kb would (C to 114,176)
            cfg, codes, lens = vote_chunk(index, sets["50kb"], 50176, True,
                                          VOTE_GLOBAL_C)
            lib = native_build.load("vote", VOTE_FUNCS)
            if not lib.lrm_vote_scratch_bytes(
                    pow2_at_least(cfg.vote_slots), cfg.max_seeds, 0):
                raise AssertionError("phase 3b: the global-scratch case "
                                     "fits shared memory")
            where = (f"50kb B={cfg.B} C={cfg.vote_slots} (rows in global "
                     "scratch) full int32")
            st = vote_case(tag, where, cfg, index[0], codes, lens)
            vote_ms[where] = [st["vote_rows_ms"], st["plain_ms"],
                              st["bound_ms"]]
        del index
        gc.collect()
        torch.cuda.empty_cache()
    rfa, rreads = repeat_genome(d, seed)
    index = load_device_index(rfa, "cuda", verbose=False)
    for exact in (False, True):
        cfg, codes, lens = vote_chunk(index, rreads, 1024, exact)
        where = (f"repeat genome 1kb B={cfg.B} C={cfg.vote_slots}"
                 f"{' exact tier' if exact else ''}")
        st = vote_case(tag, where, cfg, index[0], codes, lens)
        vote_ms[where] = [st["vote_rows_ms"], st["plain_ms"],
                          st["bound_ms"]]
        if not (st["wide"] > 0 and st["rows_past_C"] > 0):
            raise AssertionError(f"phase 3b: the repeat genome's chunk has "
                                 f"{st['wide']} wide seeds and "
                                 f"{st['rows_past_C']} rows past C")
    log(f"[{tag}] check PASS: the repeat genome's rows pass C and its "
        "seeds are wide, every kernel bit-equal")
    del index
    gc.collect()
    torch.cuda.empty_cache()
    for name, out in timed.items():
        log(f"[{tag}] {name} bucket, full int32: " + json.dumps(out))
    log(f"[{tag}] vote_rows (pick, vote and accept in one launch) ms, its "
        "plain versions' ms, bound ms, per case: " + json.dumps(vote_ms))
    return timed["1kb"]


def glue_bounds(cfg, M: int, R: int, eb: int):
    """(bound_ms, "bytes") of each glue kernel on one chunk, in
    GLUE_KERNELS' order: each input read once and each output written
    once, at HBM_BYTES_S (their operations, a few a byte, take less).
    encode: the raw bytes, codes and codes_rc.  locate_window: loc and
    lens, the contig table (M rows), one of codes / codes_rc a read, its
    L/16 + 1 text words, the six per-read outputs, q and t.  lanes: one
    centre-column entry, lens, limit, found and overflow a read; four
    outputs.  pack: the run entries, nine per-read values and the
    saturated flag; the blob and the tail."""
    B, L = cfg.B, cfg.L
    pb = 8 if cfg.pos64 else 4
    nbytes = (3 * B * L,
              B * (pb + 4) + 2 * M * pb + B * L + 4 * B * (L // 16 + 1)
              + B * (2 + 4 + 3 * pb) + 2 * B * L,
              B * (2 + 4 + 4 + 1 + 1) + B * (4 + 1 + 4 + 4),
              B * R * eb + B * (2 * pb + 3 + 16) + 1
              + B * (4 * cfg.meta_words + R * eb))
    return [(x / HBM_BYTES_S * 1e3, "bytes") for x in nbytes]


def glue_case(tag: str, where: str, mapper, reads, res=None) -> dict:
    """The step glue's four kernels on the first chunk of `reads`, in the
    step's order and each on the values the step hands it: encode on the
    raw chunk; locate_window on the seed vote's best; lanes on the DP's
    centre column (band_dp, or band_checkpoints on the gact path); pack on
    the walk's run entries.  Each bit-equal to its plain version (the
    inputs of the next from the plain version); with `res`, CUDA-event
    medians of the wrapper and its plain version and the kernel alone
    from a trace, beside the bound, into res.  Returns the max |diff| of
    each."""
    import torch
    from longreadmapper_tpu_torch.ops import step as S
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    from longreadmapper_tpu_torch.ops.band_scores import band_checkpoints
    from longreadmapper_tpu_torch.ops.gact import (gact_group_tiles,
                                                   gact_traceback_c)
    from longreadmapper_tpu_torch.ops.seed_vote import (seed_tables,
                                                        vote_rows, wide_rank)
    from longreadmapper_tpu_torch.ops.traceback import device_traceback_c
    L, prepped = mapper._prepare_chunk(reads[:mapper.B])
    cfg = mapper._step_for(L)
    _, raw, rc, lens, limits = prepped[0]
    if rc is not None:
        raise AssertionError(f"{tag}: the chunk does not ship raw bytes")
    idx = mapper.idx
    L0 = int(lens.max())
    raw, lens, limit = (torch.from_numpy(a).cuda() for a in (raw, lens,
                                                             limits))
    plains = (S.encode_raw_plain, S.locate_window_plain, S.lanes_plain,
              S.pack_plain)
    pairs = dict(zip(GLUE_KERNELS, zip(glue_wrappers(), plains)))
    calls, errs = {}, {}

    def hold(name, args):
        """The kernel and the plain version on args; the plain output."""
        kern, plain = pairs[name]
        n0 = kern.launches
        got, want = kern(*args), plain(*args)
        if kern.launches != n0 + 1:
            raise AssertionError(f"{tag}: {name} launched "
                                 f"{kern.launches - n0} kernels, not 1")
        if name == "pack":
            got, want = got.values(), want.values()
        errs[name] = check_equal(name, where, list(got), list(want), tag)
        calls[name] = (lambda: kern(*args), lambda: plain(*args))
        return want

    codes, codes_rc = hold("encode", (raw, L0))
    tabs = seed_tables(cfg, idx, codes, lens)
    best, overflow, _ = vote_rows(cfg, idx, lens, tabs, wide_rank(tabs[3]))
    found, gi, strand, off, _, _, q, t = hold(
        "locate_window", (cfg, idx, best, lens, codes, codes_rc))
    if cfg.use_gact:
        T, Wp = cfg.gact_tile, cfg.gact_W
        ckpt, wcol = band_checkpoints(q, t, T, Wp, cfg.gact_band)
        narrow = cfg.half_band
    else:
        Wp = cfg.short_W
        vdirs, wcol, nm = banded_nw_dirs(q, t, Wp, cfg.short_band)
        narrow = Wp < cfg.W
    ed_raw, band_short, ovf, lens_tb = hold(
        "lanes", (wcol, lens, limit, found, overflow, Wp, narrow))
    if cfg.use_gact:
        runs, saturated = gact_traceback_c(
            q, t, ckpt, lens_tb, T, Wp, cfg.gact_band,
            scale=cfg.gact_runs_scale,
            group=gact_group_tiles(cfg.B, cfg.L, T, cfg.gact_band,
                                   cfg.mid_dirs_budget))
    else:
        runs = device_traceback_c(
            vdirs, lens_tb, cfg.L, Wp, nm,
            entry_dtype=torch.int16 if cfg.tb_entry_bytes == 2
            else torch.int32)
        saturated = None
    hold("pack", (cfg, best, found, gi, strand, off, ed_raw, limit,
                  band_short, ovf, runs, saturated))
    stats = dict(B=cfg.B, L=cfg.L, L0=L0, path="gact" if cfg.use_gact
                 else "resident", R=runs.shape[1],
                 entry_bytes=cfg.tb_entry_bytes, found=int(found.sum()),
                 reverse=int(strand.sum()), walked=int((lens_tb > 0).sum()),
                 band_short=int(band_short.sum()))
    if res is not None:
        bounds = glue_bounds(cfg, idx.mta_start.shape[0], runs.shape[1],
                             cfg.tb_entry_bytes)
        for name, bnd in zip(GLUE_KERNELS, bounds):
            kern, plain = calls[name]
            ms = cuda_ms(kern, GLUE_TURNS)
            alone = trace_ms(kern, f"{name}_kernel", GLUE_TURNS)
            plain_ms = cuda_ms(plain, 5)
            log(f"[{tag}] {name} {where} median: wrapper {ms} ms, kernel "
                f"alone (trace) {alone} ms, plain PyTorch {plain_ms} ms "
                f"({plain_ms / ms}x); bound {bnd[0]} ms by {bnd[1]} "
                f"({bnd[0] / alone:.4f} of it reached by the kernel)")
            res.setdefault(name, {}).update(
                err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], kernel_ms=alone)
    log(f"[{tag}] {where}: {json.dumps(stats)}")
    return errs


def phase_glue(fa: str, fq: str, long_data: dict) -> dict:
    """Phase 3c (after 3b): the step glue's kernels bit-equal to their
    plain versions on each set's first chunk at its bucket, in the
    GLUE_LAYOUTS; their times at each bucket in the full int32 layout.
    Returns the 1 kb bucket's numbers (the kernels line's) with each
    kernel's max |diff| over every case."""
    import gc
    import torch
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches
    from longreadmapper_tpu_torch.utils.config import Params
    tag = "3c glue"
    sets = {"1kb": next(iter(load_read_batches(fq, 2048, background=False)))}
    for name, (reads, _, _) in long_data.items():
        sets[name] = [(n, s, None) for n, s in reads]
    timed, err = {}, {k: 0 for k in GLUE_KERNELS}
    for lname in GLUE_LAYOUTS:
        index = load_device_index(fa, "cuda", verbose=False,
                                  **LAYOUTS[lname][0])
        mapper = TorchMapper(*index, Params(), chunk_b=2048, device="cuda")
        for name, reads in sets.items():
            main = lname == GLUE_LAYOUTS[0]
            out = {} if main else None
            errs = glue_case(tag, f"{name} {lname}", mapper, reads, out)
            for k, e in errs.items():
                err[k] = max(err[k], e)
            if main:
                timed[name] = out
        del index, mapper
        gc.collect()
        torch.cuda.empty_cache()
    for name, out in timed.items():
        log(f"[{tag}] {name} bucket, full int32: " + json.dumps(out))
    for k in GLUE_KERNELS:
        timed["1kb"][k]["err"] = err[k]
    return timed["1kb"]


def make_data(d: str, seed: int, genome_len: int, n_reads: int,
              read_len: int, err: float):
    """A single-contig FASTA and a FASTQ of reads from both strands with
    substitutions; returns (fa, fq, planted forward positions, genome
    codes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as f:
        f.write(">chr1\n")
        s = acgt[g].tobytes().decode()
        f.write("\n".join(s[i:i + 70] for i in range(0, len(s), 70)) + "\n")
    pos = rng.integers(0, genome_len - read_len, n_reads)
    strand = rng.random(n_reads) < 0.5
    codes = g[pos[:, None] + np.arange(read_len)[None, :]]
    codes[strand] = 3 - codes[strand][:, ::-1]
    m = rng.random(codes.shape) < err
    codes[m] = (codes[m] + 1 + rng.integers(0, 3, int(m.sum()))) % 4
    seqs = acgt[codes]
    fq = os.path.join(d, "reads.fq")
    write_fastq(fq, [(f"r{i}", seqs[i].tobytes().decode())
                     for i in range(n_reads)])
    return fa, fq, pos, g


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def make_long_reads(g, seed: int, n_reads: int, read_len: int):
    """Reads of read_len bases from both strands at planted positions:
    3% substitutions + 0.5% 1-base insertions + 0.5% 1-base deletions;
    every HI_EVERY-th read at 7% + 0.5% + 0.5%.  Returns ([(name, seq)],
    planted forward positions, high-error flags)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    span = read_len + read_len // 50 + 64
    pos = rng.integers(0, len(g) - span, n_reads)
    hi = np.arange(n_reads) % HI_EVERY == 0
    reads = []
    for i in range(n_reads):
        src = g[pos[i]:pos[i] + span].copy()
        sub = rng.random(span) < (0.07 if hi[i] else 0.03)
        src[sub] = (src[sub] + 1 + rng.integers(0, 3, int(sub.sum()))) % 4
        r = rng.random(span)
        dele, ins = r < 0.005, (r >= 0.005) & (r < 0.01)
        counts = (~dele).astype(np.int64) + ins
        out = np.repeat(src, counts)
        # the second copy of each inserting base becomes a random base
        out[np.cumsum(counts)[ins] - 1] = rng.integers(0, 4, int(ins.sum()))
        out = out[:read_len]
        if rng.random() < 0.5:
            out = 3 - out[::-1]
        reads.append((f"r{i}", acgt[out].tobytes().decode()))
    return reads, pos, hi


def parse_sam(text: str):
    return [l.split("\t") for l in text.splitlines()
            if l and not l.startswith("@")]


def map_argv(fa: str, fq: str, n: int, device: str, chunk_b: int):
    return ["map", fa, fq, str(n), "20", "300", "--chunk-b", str(chunk_b),
            "--rg-id", "0", "--device", device]


def map_cli(fa: str, fq: str, n: int, device: str, sam: str, log_path: str,
            chunk_b: int = 0, extra=()):
    """`cli map` in-process, SAM to `sam`, its verbose log to `log_path`."""
    from longreadmapper_tpu_torch import cli
    with open(sam, "w") as f, open(log_path, "w") as e, \
            contextlib.redirect_stdout(f), contextlib.redirect_stderr(e):
        cli.main(map_argv(fa, fq, n, device, chunk_b or min(n, 2048))
                 + list(extra))


def chunk_counts(log_path: str):
    """(raw-encoded, host-encoded) chunk parts of a `cli map` log."""
    with open(log_path) as f:
        m = re.search(r"chunks: (\d+) raw-encoded on the device, (\d+) "
                      r"host-encoded", f.read())
    return (int(m.group(1)), int(m.group(2))) if m else None


def bad_alignments(recs, g) -> int:
    """Mapped records whose CIGAR does not consume exactly the read, or
    whose alignment against the genome (codes g) has another edit distance
    than the record's ED."""
    import numpy as np
    ref = np.frombuffer(b"ACGT", np.uint8)[g]
    bad = 0
    for r in recs:
        seq = np.frombuffer(r[9].encode(), np.uint8)
        qi, ri, ed = 0, int(r[3]) - 1, 0
        for n, op in re.findall(r"(\d+)([MID])", r[5]):
            n = int(n)
            if op == "M":
                a, b = seq[qi:qi + n], ref[ri:ri + n]
                ed += (int(np.count_nonzero(a != b)) if a.size == b.size
                       else n + len(seq))
            else:
                ed += n
            qi += n if op in "MI" else 0
            ri += n if op in "MD" else 0
        want = next(int(f[5:]) for f in r[11:] if f.startswith("ED:I:"))
        bad += qi != len(seq) or ed != want
    return bad


def check_map(tag: str, sam: str, map_log: str, n_reads: int, pos, g,
              tol: int, extra):
    """Log the map's SAM checks and its verbose log; raise on a failure.
    Returns the log's bucket configs and retried reads."""
    with open(sam) as f:
        recs = parse_sam(f.read())
    valid = [r for r in recs if r[1] in ("0", "16")]
    near = sum(abs(int(r[3]) - 1 - int(pos[int(r[0][1:])])) <= tol
               for r in valid)
    bad = bad_alignments(valid, g)
    buckets, retried = [], None
    with open(map_log) as f:
        for line in f:
            log(f"[{tag}] log: {line.rstrip()}")
            if "] bucket " in line:
                buckets.append(json.loads(line.split("] bucket ", 1)[1]))
            m = re.search(r"retried reads (\d+)", line)
            if m:
                retried = int(m.group(1))
    chunks = chunk_counts(map_log)
    checks = [
        (len(recs) == n_reads, f"records {len(recs)} == {n_reads}"),
        (len(valid) >= 0.99 * n_reads,
         f"valid {len(valid)} >= 0.99 * {n_reads}"),
        (near >= 0.99 * len(valid),
         f"within {tol} bp of planted {near} >= 0.99 * {len(valid)}"),
        (bad == 0, f"CIGARs that miss the read's length or the ED {bad} "
                   "== 0"),
    ] + [c(buckets, retried, chunks) for c in extra]
    for ok, what in checks:
        log(f"[{tag}] check {'PASS' if ok else 'FAIL'}: {what}")
    if not all(ok for ok, _ in checks):
        raise AssertionError(f"{tag} failed")


def plain_counts():
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import (banded_nw_dirs_v,
                                                        banded_nw_scores)
    return (banded_nw_dirs_v.cuda_calls + banded_nw_scores.cuda_calls
            + gact_forward.cuda_calls)


def reset_counts():
    """Every kernel's launch count, every plain version's CUDA call count
    (the seed vote's, top2_votes' and the step glue's too) and the walks'
    host syncs to 0;
    the peak memory statistic too."""
    import torch
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_tiles,
                                                      banded_nw_dirs)
    from longreadmapper_tpu_torch.ops.band_scores import band_scores
    from longreadmapper_tpu_torch.ops.gact import (gact_forward,
                                                   gact_traceback_c,
                                                   gact_traceback_c_plain)
    from longreadmapper_tpu_torch.ops.traceback import (
        device_traceback_c, device_traceback_c_plain)
    from longreadmapper_tpu_torch.ops.wavefront import (banded_nw_dirs_v,
                                                        banded_nw_scores)
    from longreadmapper_tpu_torch.ops import seed_vote, step, vote
    for fn in (banded_nw_dirs, band_dp_tiles, band_scores,
               device_traceback_c, gact_traceback_c, seed_vote.seed_tables,
               seed_vote.vote_rows, vote.top2_votes) + glue_wrappers():
        fn.launches = 0
    for fn in (banded_nw_dirs_v, banded_nw_scores, gact_forward,
               device_traceback_c_plain, gact_traceback_c_plain,
               seed_vote.seed_tables_plain, seed_vote.vote_rows_plain,
               seed_vote.seed_accept_plain, vote.top2_votes_plain,
               step.encode_raw_plain, step.locate_window_plain,
               step.lanes_plain, step.pack_plain):
        fn.cuda_calls = 0
    device_traceback_c.host_syncs = gact_traceback_c.host_syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def glue_wrappers() -> tuple:
    """The step glue's wrappers, in GLUE_KERNELS' order."""
    from longreadmapper_tpu_torch.ops import step
    return step.encode_raw, step.locate_window, step.lanes, step.pack


def walk_syncs() -> int:
    from longreadmapper_tpu_torch.ops.gact import gact_traceback_c
    from longreadmapper_tpu_torch.ops.traceback import device_traceback_c
    return device_traceback_c.host_syncs + gact_traceback_c.host_syncs


# the walk, seed-vote and glue kernels' launches over the main path's runs
# (phases 4, 7, 10, 11)
MAIN_LAUNCHES = {"walk_c": 0, "gact_walk": 0, "seed_tables": 0,
                 "vote_rows": 0, **{k: 0 for k in GLUE_KERNELS}}


def path_checks(need, raw: bool = True) -> list:
    """(ok, what) checks of a map run on the card since reset_counts():
    the seed vote's two kernels, each walk kernel of `need` and the step
    glue's kernels (the raw encode only where the run's chunks ship raw
    bytes, `raw`) launched, no plain walk, seed vote or glue called on
    CUDA, no walk host sync.  Adds the run's launches to MAIN_LAUNCHES."""
    from longreadmapper_tpu_torch.ops import seed_vote, step, vote
    from longreadmapper_tpu_torch.ops.gact import (gact_traceback_c,
                                                   gact_traceback_c_plain)
    from longreadmapper_tpu_torch.ops.traceback import (
        device_traceback_c, device_traceback_c_plain)
    run = {"walk_c": device_traceback_c.launches,
           "gact_walk": gact_traceback_c.launches,
           "seed_tables": seed_vote.seed_tables.launches,
           "vote_rows": seed_vote.vote_rows.launches,
           **{k: f.launches for k, f in zip(GLUE_KERNELS, glue_wrappers())}}
    plain_glue = (step.encode_raw_plain.cuda_calls
                  + step.locate_window_plain.cuda_calls
                  + step.lanes_plain.cuda_calls + step.pack_plain.cuda_calls)
    plain = (device_traceback_c_plain.cuda_calls
             + gact_traceback_c_plain.cuda_calls)
    plain_vote = (seed_vote.seed_tables_plain.cuda_calls
                  + seed_vote.vote_rows_plain.cuda_calls
                  + seed_vote.seed_accept_plain.cuda_calls
                  + vote.top2_votes_plain.cuda_calls)
    syncs = walk_syncs()
    for k, v in run.items():
        MAIN_LAUNCHES[k] += v
    need = tuple(need) + ("seed_tables", "vote_rows") + GLUE_KERNELS[
        0 if raw else 1:]
    return [(all(run[k] > 0 for k in need),
             f"walk, seed-vote and glue kernel launches {json.dumps(run)}: "
             f"{', '.join(need)} > 0"),
            (plain == 0 and syncs == 0,
             f"plain walk calls on CUDA {plain} == 0, walk host syncs "
             f"{syncs} == 0"),
            (plain_vote == 0,
             f"plain seed-vote calls on CUDA (seed_tables, vote_rows, "
             f"the accept, top2_votes) {plain_vote} == 0"),
            (plain_glue == 0,
             f"plain step glue calls on CUDA (encode, locate_window, lanes, "
             f"pack) {plain_glue} == 0")]


def as_extra(checks) -> list:
    """check_map extras of (ok, what) checks."""
    return [lambda b, r, c, ok=ok, what=what: (ok, what)
            for ok, what in checks]


def phase_lch(fa: str) -> None:
    """Phase 4, the lchash: the .lch that `cli index` built on the card
    against the host build from the suffix array (in-process, timed), then
    the card build timed at each of LCH_CHUNKS k-mers a batch."""
    import numpy as np
    import torch
    from longreadmapper_tpu_torch.formats.catmeta import load_cat
    from longreadmapper_tpu_torch.formats.lch import read_lch
    from longreadmapper_tpu_torch.index.device import DeviceIndex, bwt_arrays
    from longreadmapper_tpu_torch.index.fmi import FMIndex, encode_bytes
    from longreadmapper_tpu_torch.index.lchash import (DEVICE_CHUNK,
                                                       lc_build_device,
                                                       lc_build_from_sa)
    hlen, card = read_lch(fa + ".cat.lch")
    fmi = FMIndex.read(fa + ".cat", with_sa=True)
    t0 = time.perf_counter()
    host = lc_build_from_sa(fmi.sa, encode_bytes(load_cat(fa + ".cat")),
                            hlen)
    t_host = time.perf_counter() - t0
    same = card.dtype == host.dtype and np.array_equal(card, host)
    log(f"[4 map] lchash (hlen {hlen}, {card.shape[0]} k-mers): host build "
        f"from the SA (lc_build_from_sa) in {t_host} s")
    log(f"[4 map] check {'PASS' if same else 'FAIL'}: the card-built .lch "
        f"equals the host build byte for byte ({card.nbytes} bytes)")
    if not same:
        raise AssertionError("phase 4 failed: the card's lchash differs")
    del card
    arrays, dollar_pos = bwt_arrays(fmi)
    arrays["c4"] = fmi.c4().astype(np.int32)
    idx = DeviceIndex.from_arrays(arrays, "cuda")
    for chunk in LCH_CHUNKS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kl = lc_build_device(idx.packed, idx.occ_samp, idx.c4, dollar_pos,
                             fmi.length, hlen, chunk=chunk)
        t = time.perf_counter() - t0
        if not np.array_equal(kl, host):
            raise AssertionError(f"lc_build_device at chunk {chunk} "
                                 "differs from the host build")
        log(f"[4 map] lc_build_device, {chunk} k-mers a batch "
            f"({-(-host.shape[0] // chunk)} batches x {hlen} steps"
            f"{', the default' if chunk == DEVICE_CHUNK else ''}): {t} s, "
            "equal to the host build")


def phase_map(d: str, seed: int, n_reads: int, genome_len: int = 4_000_000):
    import torch
    from longreadmapper_tpu_torch import cli
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs

    t0 = time.perf_counter()
    fa, fq, pos, g = make_data(d, seed, genome_len, n_reads, 1000, 0.03)
    log(f"[4 map] data made in {time.perf_counter() - t0} s "
        f"({genome_len} bp genome, {n_reads} reads of 1 kb, 3% "
        "substitutions)")
    index_log = os.path.join(d, "index.log")
    t0 = time.perf_counter()
    with open(index_log, "w") as e, contextlib.redirect_stderr(e):
        cli.main(["index", fa])            # lchash on the card (--device)
    log(f"[4 map] cli index (hlen by auto_hlen, the lchash on the card) in "
        f"{time.perf_counter() - t0} s")
    with open(index_log) as f:
        for line in f:
            log(f"[4 map] index log: {line.rstrip()}")
    phase_lch(fa)

    sam = os.path.join(d, "out.sam")
    map_log = os.path.join(d, "map.log")
    reset_counts()
    t0 = time.perf_counter()
    map_cli(fa, fq, n_reads, "cuda", sam, map_log)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    launches, plain = banded_nw_dirs.launches, plain_counts()
    walks = path_checks(("walk_c",))
    log(f"[4 map] cli map in {t_map} s = {n_reads / t_map} reads/s "
        "end to end (index load included)")
    with open(map_log) as f:
        phase_s = json.loads(re.search(r"phase_s (\{.*\})", f.read())[1])
    n_chunks = -(-n_reads // 2048)
    log(f"[4 map] a chunk: dispatch {phase_s['dispatch'] / n_chunks * 1e3} "
        f"ms, fetch {phase_s['fetch'] / n_chunks * 1e3} ms ({n_chunks} "
        "chunks; phase 6 times the step)")
    log(f"[4 map] walk host syncs {walk_syncs()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    check_map("4 map", sam, map_log, n_reads, pos, g, 16, [
        lambda b, r, c: (launches > 0, f"band_dp kernel launches "
                                       f"{launches} > 0"),
        lambda b, r, c: (plain == 0, f"plain DP calls on CUDA {plain} == 0"),
        lambda b, r, c: (c == (n_chunks, 0), f"chunks (raw-encoded on the "
                                             f"card, host-encoded) {c} == "
                                             f"({n_chunks}, 0)")]
              + as_extra(walks))
    return fa, fq, pos, g, launches


def cpu_maps(d: str, fa: str, sets):
    """Phase 5, first half.  sets: (name, fq, n_reads, chunk_b).  Starts
    `cli map --device cpu` of every set as a subprocess, all at once, and
    maps the same reads on the card meanwhile; returns (the subprocesses,
    the card's SAM texts).  The CPU maps take minutes: the caller runs its
    other phases beside them, then check_cpu_maps, and stop() in any case."""
    import torch
    cores = len(os.sched_getaffinity(0))
    env = dict(os.environ,
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = []
    try:
        for name, fq, n, cb in sets:
            sam = os.path.join(d, f"{name}.cpu.sam")
            threads = max(1, cores * CPU_THREADS[name] // 8)
            env["OMP_NUM_THREADS"] = str(threads)
            with open(sam, "w") as f, open(sam + ".log", "w") as e:
                procs.append((sam, threads, time.perf_counter(),
                              subprocess.Popen(
                    [sys.executable, "-m", "longreadmapper_tpu_torch.cli"]
                    + map_argv(fa, fq, n, "cpu", cb), stdout=f, stderr=e,
                    env=env, cwd=HERE)))
        texts = {}
        for name, fq, n, cb in sets:
            sam = os.path.join(d, f"{name}.cuda.sam")
            t0 = time.perf_counter()
            map_cli(fa, fq, n, "cuda", sam, sam + ".log", cb)
            torch.cuda.synchronize()
            log(f"[5 cpu] {name}: cli map of {n} reads on cuda in "
                f"{time.perf_counter() - t0} s (index load included)")
            with open(sam) as f:
                texts[name] = f.read()
    except BaseException:
        stop(procs)
        raise
    return procs, texts


def check_cpu_maps(sets, procs, texts) -> None:
    """Phase 5, second half: waits for the CPU maps and holds their SAM
    byte-identical to the card's."""
    for (name, fq, n, cb), (sam, threads, t0, p) in zip(sets, procs):
        rc = p.wait()
        log(f"[5 cpu] {name}: cli map of {n} reads on cpu ({threads} "
            f"threads) in {time.perf_counter() - t0} s, exit {rc}")
        if rc != 0:
            with open(sam + ".log") as f:
                raise RuntimeError(f"cpu map of {name} failed:\n"
                                   + f.read()[-3000:])
        with open(sam) as f:
            cpu = f.read()
        raw = [chunk_counts(os.path.join(os.path.dirname(sam),
                                         f"{name}.{dev}.sam.log"))
               for dev in ("cpu", "cuda")]
        same = (cpu == texts[name] and len(parse_sam(cpu)) == n
                and all(c is not None and c[0] > 0 and c[1] == 0
                        for c in raw))
        log(f"[5 cpu] check {'PASS' if same else 'FAIL'}: {name}: SAM "
            f"of {n} reads byte-identical between the CPU (plain "
            f"versions) and the card ({len(cpu)} bytes), every chunk "
            f"encoded on its device (raw-encoded, host-encoded: cpu "
            f"{raw[0]}, card {raw[1]})")
        if not same:
            raise AssertionError("phase 5 failed")


def stop(procs) -> None:
    for *_, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@contextlib.contextmanager
def plain_seed_vote():
    """The mapping step's seed vote through the plain versions (the split
    before the kernels), for the `with` block."""
    from longreadmapper_tpu_torch.mapping import pipeline
    from longreadmapper_tpu_torch.ops import seed_vote
    saved = pipeline.seed_tables, pipeline.vote_rows
    pipeline.seed_tables = seed_vote.seed_tables_plain
    pipeline.vote_rows = seed_vote.vote_accept_plain
    try:
        yield
    finally:
        pipeline.seed_tables, pipeline.vote_rows = saved


def step_syncs(tag: str, index, reads, mode: str) -> list:
    """One chunk's map_step (its first part, as the mapper packs it) run
    once to warm up, then again under torch.cuda.set_sync_debug_mode(mode):
    "error" raises at the first op that waits for the card; "warn" records
    each such op.  Raises unless the bytes equal the warm-up's; returns the
    recorded syncs as "file:line: message"."""
    import warnings
    import torch
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.runtime.stages import _step
    from longreadmapper_tpu_torch.utils.config import Params
    idx, meta, mta = index
    mapper = TorchMapper(idx, meta, mta, Params(), chunk_b=2048,
                         device="cuda")
    L, prepped = mapper._prepare_chunk(reads[:mapper.B])
    cfg = mapper._step_for(L)
    step = _step(cfg, idx, *prepped[0][1:], mapper.device)
    want = step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            got = step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}: {w.message}"
             for w in caught if "ynchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    same = all(torch.equal(got[k], want[k]) for k in want)
    log(f"[{tag}] map_step of B={cfg.B} L={cfg.L} under "
        f"set_sync_debug_mode({mode!r}): {len(syncs)} host syncs"
        + "".join(f"\n[{tag}]   sync at {x}" for x in syncs))
    if not same:
        raise AssertionError(f"{tag}: the step's bytes changed under the "
                             "sync debug mode")
    return syncs


def phase_stages(tag: str, fa: str, reads, traced_steps: int = 3,
                 sync_mode: str = "error"):
    """Per-stage times of the mapping step on `reads` with the seed vote's
    kernels and with its plain versions, each with a device trace; then
    the step under set_sync_debug_mode(sync_mode) (step_syncs).  Returns
    the recorded syncs."""
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch.runtime.stages import stage_times

    index = load_device_index(fa, "cuda", verbose=False)
    for kind in ("kernels", "plain"):
        with (plain_seed_vote() if kind == "plain"
              else contextlib.nullcontext()):
            st = stage_times(fa, reads, chunk_b=2048, device="cuda",
                             traced_steps=traced_steps, index=index)
        trace = st.pop("trace")
        label = f"{tag}, seed vote by its {kind}"
        log(f"[{label}] " + json.dumps(st))
        log(f"[{label}] trace " + (json.dumps(trace) if trace else
                                   "not measured: the profiler saw no "
                                   "device kernels"))
    return step_syncs(tag, index, reads, sync_mode)


def phase_long(d: str, fa: str, g, name: str, reads, pos, hi) -> dict:
    import torch
    from longreadmapper_tpu_torch.ops.band_dp import band_dp_tiles
    from longreadmapper_tpu_torch.ops.band_scores import band_scores

    n, read_len, want_cfg = LONG_SETS[name]
    tag = f"7 long {name}"
    fq = os.path.join(d, f"{name}.fq")
    sam = os.path.join(d, f"{name}.sam")
    reset_counts()
    t0 = time.perf_counter()
    map_cli(fa, fq, n, "cuda", sam, sam + ".log", 2048)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    # band_dp_wide's launches (band_dp_tiles: one a resident pass, one a
    # group of gact tiles) and band_scores's (one a gact pass)
    counts = dict(band_dp_wide=band_dp_tiles.launches,
                  band_scores=band_scores.launches)
    tiles_a_pass = want_cfg["L"] // 512          # MapperConfig.gact_tile
    plain = plain_counts()
    # 10 kb: the resident first pass walks by walk_c, the full-band retry
    # by gact_walk; 50 kb: every pass by gact_walk
    walks = path_checks(("walk_c", "gact_walk") if want_cfg["path"]
                        == "resident" else ("gact_walk",))
    n_hi = int(hi.sum())
    log(f"[{tag}] cli map of {n} reads of {read_len} bp in {t_map} s = "
        f"{n / t_map} reads/s, {n * read_len / t_map / 1e6} Mb/s end to end "
        "(index load included)")
    log(f"[{tag}] launches {json.dumps(counts)}, walk host syncs "
        f"{walk_syncs()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    # both sets launch both kernels: at 10 kb the first pass is resident
    # (band_dp_wide, one launch a chunk) and the full-band retry takes gact
    # (band_scores, then band_dp_wide in groups of tiles); at 50 kb every
    # pass is gact, one band_scores launch a pass
    check_map(tag, sam, sam + ".log", n, pos, g, max(16, read_len // 100), [
        lambda b, r, c: (b == [want_cfg], f"bucket configs {b} == "
                                          f"[{want_cfg}]"),
        lambda b, r, c: (r is not None and r >= n_hi,
                         f"retried reads {r} >= high-error reads {n_hi}"),
        lambda b, r, c: (counts["band_dp_wide"] > 0
                         and counts["band_scores"] > 0,
                         f"launches {counts}: band_dp_wide and band_scores "
                         "> 0"),
        lambda b, r, c: (counts["band_dp_wide"]
                         < tiles_a_pass * counts["band_scores"],
                         f"band_dp_wide launches {counts['band_dp_wide']} < "
                         f"{tiles_a_pass} tiles x {counts['band_scores']} "
                         "gact passes"),
        lambda b, r, c: (plain == 0, f"plain DP / scores / gact_forward "
                                     f"calls on CUDA {plain} == 0"),
        lambda b, r, c: (c is not None and c[0] > 0 and c[1] == 0,
                         f"chunks (raw-encoded on the card, host-encoded) "
                         f"{c}: all raw")] + as_extra(walks))
    phase_stages(tag, fa, [(nm, s, None) for nm, s in reads], 1,
                 "error" if want_cfg["path"] == "resident" else "warn")
    return counts


def map_sam(index, fq: str, n: int, chunk_b: int):
    """`cli map`'s SAM (seed 20, threshold 300, @RG id 0) of `fq`, mapped
    in-process on the card over an index already loaded; returns the SAM
    text and the mapper."""
    import torch
    from longreadmapper_tpu_torch.formats.sam import sam_header
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.runtime.reads import (chunks,
                                                        load_read_batches)
    from longreadmapper_tpu_torch.utils.config import Params
    idx, meta, mta = index
    mapper = TorchMapper(idx, meta, mta, Params(batch_size=n),
                         chunk_b=chunk_b, device="cuda")
    parts = [sam_header(mta, 0)]
    for batch in load_read_batches(fq, n):
        for text, _, _ in mapper.map_stream_sam(chunks(batch, mapper.B)):
            parts.append(text)
    torch.cuda.synchronize()
    return "".join(parts), mapper


def phase_layouts(d: str, fa: str, refs: dict, pos, g, stage_reads):
    """Phase 8.  refs: set name -> (fastq, reads, chunk_b, the full int32
    layout's SAM text on the card); pos: the 1 kb reads' planted
    positions."""
    import gc
    from dataclasses import fields
    import torch
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch.runtime.stages import stage_times

    fq1, n1, cb1, ref1 = refs["1kb"]
    sam = os.path.join(d, "slim.cli.sam")
    t0 = time.perf_counter()
    map_cli(fa, fq1, n1, "cuda", sam, sam + ".log", cb1, ["--slim-index"])
    log(f"[8 layouts] cli map --slim-index of {n1} reads in "
        f"{time.perf_counter() - t0} s (index load included)")
    with open(sam) as f:
        same = f.read() == ref1
    check_map("8 layouts slim cli", sam, sam + ".log", n1, pos, g, 16, [
        lambda b, r, c: (same, "SAM byte-identical to the full int32 "
                               "layout's (phase 4)"),
        lambda b, r, c: (c is not None and c[1] == 0, f"chunks {c}: all "
                                                      "raw")])
    total = torch.cuda.get_device_properties(0).total_memory
    for name, (load, want_bpp) in LAYOUTS.items():
        tag = f"8 layouts {name}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = load_device_index(fa, "cuda", verbose=False, **load)
        t_load = time.perf_counter() - t0
        idx, meta = index[0], index[1]
        tables = {f.name: getattr(idx, f.name).nbytes for f in fields(idx)
                  if getattr(idx, f.name) is not None}
        lch = tables["lch"] + tables.get("lch_hi", 0)
        table_bytes = sum(tables.values())
        bpp = (table_bytes - lch) / meta.n
        log(f"[{tag}] index loaded in {t_load} s: {meta}; device bytes of "
            f"the tables {table_bytes} ({json.dumps(tables)}); "
            f"{bpp} bytes a position without lch/lch_hi")
        checks = [(abs(bpp - want_bpp) <= 0.02 * want_bpp,
                   f"bytes a position {bpp} within 2% of {want_bpp}")]
        for set_name, (fq, n, cb, ref) in refs.items():
            t0 = time.perf_counter()
            text, mapper = map_sam(index, fq, n, cb)
            t_map = time.perf_counter() - t0
            stream_s = sum(mapper.phase_s.values())
            recs = parse_sam(text)
            bad = bad_alignments([r for r in recs if r[1] in ("0", "16")],
                                 g)
            log(f"[{tag}] {set_name}: {n} reads in {t_map} s, "
                f"{n / stream_s} reads/s over the stream (phase_s "
                f"{json.dumps(mapper.phase_s)}); retried reads "
                f"{mapper.retried_reads}; chunks raw {mapper.raw_chunks} / "
                f"host {mapper.host_chunks}")
            checks += [(text == ref, f"{set_name}: SAM byte-identical to "
                                     "the full int32 layout's"),
                       (len(recs) == n and bad == 0,
                        f"{set_name}: records {len(recs)} == {n}, CIGARs "
                        f"that miss the read or the ED {bad} == 0")]
            if set_name == "1kb":
                peak = torch.cuda.max_memory_allocated()
                work = peak - table_bytes
                # the most positions the card's memory leaves room for
                # beside the lchash and the 1 kb map's working memory, and
                # the most the position width addresses; the .cat holds
                # both strands, so a genome of half as many bp
                by_memory = (total - lch - work) / bpp / 2
                by_width = 2 ** (40 if meta.pos_dtype == "int64" else 31) / 2
                log(f"[{tag}] peak device memory {peak} bytes, of which "
                    f"the 1 kb map's working memory {work}; largest genome "
                    f"the card would hold (computed, not measured): "
                    f"{min(by_memory, by_width) / 1e9} Gb (by memory "
                    f"{by_memory / 1e9}, by position width "
                    f"{by_width / 1e9})")
        st = stage_times(fa, stage_reads, chunk_b=2048, device="cuda",
                         traced_steps=0, index=index)
        log(f"[{tag}] stages {json.dumps(st)}")
        for ok, what in checks:
            log(f"[{tag}] check {'PASS' if ok else 'FAIL'}: {what}")
        if not all(ok for ok, _ in checks):
            raise AssertionError(f"{tag} failed")
        del index, idx, mapper
        gc.collect()
        torch.cuda.empty_cache()


def same_files(a: str, b: str, chunk: int = 1 << 26) -> bool:
    """Byte equality of two files, read in chunks (the .lch is 4.3 GB)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def stage_seconds(index_log: str, stage: str) -> float:
    """The seconds of `stage` in a `cli index` log ("<stage> done in Ns")."""
    with open(index_log) as f:
        return float(re.search(stage + r" done in ([0-9.]+)s",
                               f.read()).group(1))


def phase_index(d: str, fa: str, fq: str, pos, g, seed: int) -> None:
    """Phase 9: the external suffix-array build through `cli index
    --ram-gb`, the card's prefix-doubling build at two sizes, and the
    affine aligner at the 1 kb main shape."""
    import shutil
    import numpy as np
    import torch
    from longreadmapper_tpu_torch import cli
    from longreadmapper_tpu_torch.formats.catmeta import load_cat
    from longreadmapper_tpu_torch.formats.ui40 import read_sa5
    from longreadmapper_tpu_torch.index.fmi import encode_bytes
    from longreadmapper_tpu_torch.index.sa import (sa_build_device,
                                                   suffix_array)
    from longreadmapper_tpu_torch.ops.affine import (affine_align,
                                                     banded_sw_affine)
    out, checks = {}, []
    prefix = fa + ".cat"
    n = os.path.getsize(prefix)

    # the external build on a copy of the phase-4 FASTA
    ext = os.path.join(d, "ext")
    os.makedirs(ext)
    fa2 = os.path.join(ext, "ref.fa")
    shutil.copyfile(fa, fa2)
    # a budget of one block of ceil(n / EXT_BLOCKS) + 1 chars at 12 B a
    # char (exact in GB: a power-of-2 division)
    ram_gb = 12 * (-(-n // EXT_BLOCKS) + 1) / 2**30
    index_log = os.path.join(ext, "index.log")
    t0 = time.perf_counter()
    with open(index_log, "w") as e, contextlib.redirect_stderr(e):
        cli.main(["index", fa2, "--ram-gb", repr(ram_gb)])
    out["ext_index_s"] = time.perf_counter() - t0
    with open(index_log) as f:
        for line in f:
            log(f"[9 index] --ram-gb index log: {line.rstrip()}")
    with open(index_log) as f:
        out["blocks"] = int(re.search(r"external build, (\d+) blocks",
                                      f.read()).group(1))
    out["ext_sa_s"] = stage_seconds(index_log, "sa_build")
    out["in_ram_sa_s"] = stage_seconds(os.path.join(d, "index.log"),
                                       "sa_build")
    log(f"[9 index] cli index --ram-gb {ram_gb} ({ram_gb * 2**30:.0f} "
        f"bytes, n = {n}): {out['blocks']} blocks, in "
        f"{out['ext_index_s']} s; sa_build stage {out['ext_sa_s']} s "
        f"against phase 4's in-RAM {out['in_ram_sa_s']} s")
    names = [".mta", ".cat", ".cat.sa5", ".cat.mfi", ".cat.lch"]
    cache = sorted(os.listdir(fa + ".cat.devidx"))
    names += [os.path.join(".cat.devidx", c) for c in cache]
    differ = [nm for nm in names if not same_files(fa + nm, fa2 + nm)]
    checks += [(out["blocks"] == EXT_BLOCKS,
                f"external blocks {out['blocks']} == {EXT_BLOCKS}"),
               (sorted(os.listdir(fa2 + ".cat.devidx")) == cache
                and not differ,
                f"the five artifacts and the {len(cache)} devidx files "
                f"byte-identical to phase 4's in-RAM build (differ: "
                f"{differ})")]
    shutil.rmtree(ext)

    # the card's prefix doubling on the phase-4 .cat, and on a larger .cat
    want = read_sa5(prefix + ".sa5")
    codes = encode_bytes(load_cat(prefix))
    rng = np.random.default_rng(seed + 9)
    big = rng.integers(0, 4, BIG_SA_GENOME).astype(np.uint8)
    big = np.concatenate([big, 3 - big[::-1], [4]]).astype(np.uint8)
    for name, c in (("phase-4 .cat", codes), ("random .cat", big)):
        if c is big:
            t0 = time.perf_counter()
            want = suffix_array(np.frombuffer(b"ACGT$", np.uint8)[c])
            out["host_sais_big_s"] = time.perf_counter() - t0
            log(f"[9 index] host SA-IS (csrc/sais.cpp) on the {name}, n = "
                f"{c.shape[0]}: {out['host_sais_big_s']} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = sa_build_device(c, device="cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        key = "big" if c is big else "cat"
        out[f"sa_device_{key}_ms"] = statistics.median(times) * 1e3
        out[f"sa_device_{key}_rounds"] = sa_build_device.rounds
        out[f"sa_device_{key}_peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[9 index] sa_build_device on the {name}, n = {c.shape[0]}: "
            f"{out[f'sa_device_{key}_ms']} ms (median of 3: {times} s; "
            f"host in, host out), {sa_build_device.rounds} rounds, peak "
            f"device memory {out[f'sa_device_{key}_peak_bytes']} bytes")
        checks.append((np.array_equal(got, want),
                       f"sa_build_device on the {name} equals "
                       + ("the host SA-IS" if c is big else
                          "phase 4's .sa5") + " element for element"))
        del got, want
    del big

    # the affine scorer at the 1 kb main shape: the reads turned to the
    # forward strand (the orientation with fewer mismatches) against
    # their planted windows
    B, L, W, band = MAIN_SHAPE
    code = np.full(256, 4, np.uint8)
    code[list(b"ACGT")] = range(4)
    with open(fq) as f:
        seqs = [line.strip() for i, line in enumerate(f) if i % 4 == 1][:B]
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    for b, s in enumerate(seqs):
        r = code[np.frombuffer(s.encode(), np.uint8)]
        win = g[pos[b]:pos[b] + L]
        rc = 3 - r[::-1]
        m = len(r)
        if np.count_nonzero(rc != win[:m]) < np.count_nonzero(r != win[:m]):
            r = rc
        q[b, :m] = r
        t[b, :win.shape[0]] = win
    qc, tc = torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()
    got = banded_sw_affine(qc, tc, W, band)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = banded_sw_affine(torch.from_numpy(q), torch.from_numpy(t), W,
                           band)
    out["affine_cpu_s"] = time.perf_counter() - t0
    same = all(torch.equal(x.cpu(), y) for x, y in zip(got, cpu))
    sc, ei, ej = (x.cpu().numpy() for x in got)
    agree = 0
    for b in range(N_AFFINE_ALIGN):
        score, span, _ = affine_align(q[b], t[b], W)
        agree += (sc[b], ei[b], ej[b]) == ((score, span[1], span[3])
                                           if score else (0, 0, 0))
    out["affine_ms"] = cuda_ms(lambda: banded_sw_affine(qc, tc, W, band), 3)
    log(f"[9 index] banded_sw_affine (B, L, W, band) = {MAIN_SHAPE}: "
        f"{out['affine_ms']} ms on the card (median of 3, CUDA events), "
        f"{out['affine_cpu_s']} s on the CPU; scores {sc.min()}-{sc.max()}, "
        f"mean {sc.mean()}")
    checks += [(same, "banded_sw_affine on the card bit-equal to the same "
                      "call on the CPU (score, end_i, end_j)"),
               (agree == N_AFFINE_ALIGN,
                f"score, end_i, end_j equal to affine_align for {agree} of "
                f"{N_AFFINE_ALIGN} reads"),
               (bool((sc > 0).all()), "every read scores > 0")]
    log("[9 index] " + json.dumps(out))
    for ok, what in checks:
        log(f"[9 index] check {'PASS' if ok else 'FAIL'}: {what}")
    if not all(ok for ok, _ in checks):
        raise AssertionError("phase 9 failed")


def mapdist_cli(fa: str, fq: str, n: int, prefix: str, log_path: str,
                extra=()):
    """`cli mapdist --device cuda --rg-id 0 --chunk-b 2048` in-process at
    world 1 (the command forms its own NCCL group and destroys it), its
    verbose log to `log_path`; returns its global (valid, total)."""
    from longreadmapper_tpu_torch import cli
    with open(log_path, "w") as e, contextlib.redirect_stderr(e):
        rc = cli.main(["mapdist", fa, fq, str(n), "20", "300", "--chunk-b",
                       "2048", "--rg-id", "0", "--device", "cuda",
                       "--out-prefix", prefix] + list(extra))
    with open(log_path) as f:
        m = re.search(r"global sensitivity: (\d+)/(\d+)", f.read())
    if rc != 0 or m is None:
        raise AssertionError(f"cli mapdist {extra} exited {rc} without its "
                             "sensitivity line")
    return int(m.group(1)), int(m.group(2))


def dist_launches():
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_tiles,
                                                      banded_nw_dirs)
    from longreadmapper_tpu_torch.ops.band_scores import band_scores
    return dict(band_dp=banded_nw_dirs.launches,
                band_dp_wide=band_dp_tiles.launches,
                band_scores=band_scores.launches)


# phase 10: `cli warmup` then `cli map` in one fresh process (or the map
# alone), timing the first chunk's dispatch seconds (TorchMapper.phase_s)
WARM_MAP = r"""
import contextlib, json, sys, time
sys.path.insert(0, sys.argv[1])
from longreadmapper_tpu_torch import cli
from longreadmapper_tpu_torch.models.mapper import TorchMapper
fa, fq, n, warm, sam = sys.argv[2:7]
first = []
submit = TorchMapper.submit_chunk

def timed(self, reads):
    d0 = self.phase_s["dispatch"]
    out = submit(self, reads)
    if not first:
        first.append(self.phase_s["dispatch"] - d0)
    return out

TorchMapper.submit_chunk = timed
t0 = time.perf_counter()
if warm == "1":
    assert cli.main(["warmup", fa, "--lengths", "1024", "--chunk-b", "2048",
                     "--device", "cuda", "--quiet"]) == 0
t1 = time.perf_counter()
with open(sam, "w") as f, contextlib.redirect_stdout(f):
    assert cli.main(["map", fa, fq, n, "20", "300", "--chunk-b", "2048",
                     "--rg-id", "0", "--device", "cuda", "--quiet"]) == 0
print(json.dumps(dict(warmup_s=t1 - t0, map_s=time.perf_counter() - t1,
                      first_dispatch_s=first[0])))
"""


def phase_dist(d: str, fa: str, fq: str, n_reads: int, pos, g, long10,
               stage_reads) -> dict:
    """Phase 10.  long10: (the 10 kb reads, their planted positions).
    Returns the kernels' launches of the phase's mapdist runs."""
    import torch
    import torch.distributed as dist
    from longreadmapper_tpu_torch.index.device import load_host_index
    from longreadmapper_tpu_torch.parallel.dist import shard_index
    from longreadmapper_tpu_torch.parallel.mesh import make_mesh
    from longreadmapper_tpu_torch.runtime.launch import init_distributed
    from longreadmapper_tpu_torch.runtime.stages import stage_times

    with open(os.path.join(d, "out.sam")) as f:
        ref = f.read()
    ref_valid = sum(r[1] in ("0", "16") for r in parse_sam(ref))
    counts = dict(band_dp=0, band_dp_wide=0, band_scores=0)
    for name, extra in (("replicated", []),
                        ("shard-index", ["--shard-index"])):
        tag = f"10 dist {name}"
        prefix = os.path.join(d, f"dist.{name}.sam")
        reset_counts()
        t0 = time.perf_counter()
        valid, total = mapdist_cli(fa, fq, n_reads, prefix,
                                   prefix + ".log", extra)
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        run = dist_launches()
        plain = plain_counts()
        # the mesh ships host codes: no raw encode
        walks = path_checks(("walk_c",), raw=False)
        for k, v in run.items():
            counts[k] += v
        log(f"[{tag}] cli mapdist (world 1, NCCL) of {n_reads} reads in "
            f"{t_map} s = {n_reads / t_map} reads/s end to end (index load "
            f"included); launches {json.dumps(run)}")
        with open(prefix + ".part0") as f:
            same = f.read() == ref
        check_map(tag, prefix + ".part0", prefix + ".log", n_reads, pos, g,
                  16, [
            lambda b, r, c: (same, "part0 byte-identical to phase 4's cli "
                                   "map SAM"),
            lambda b, r, c: ((valid, total) == (ref_valid, n_reads),
                             f"global (valid, total) {(valid, total)} == "
                             f"phase 4's {(ref_valid, n_reads)}"),
            lambda b, r, c: (run["band_dp"] > 0 and plain == 0,
                             f"band_dp launches {run['band_dp']} > 0, plain "
                             f"DP calls on CUDA {plain} == 0")]
                  + as_extra(walks))

    # the first N_DIST_LONG 10 kb reads: the mesh's full-band first pass
    # takes gact (band_scores, then band_dp_wide in groups of tiles)
    reads, lpos = long10
    n = N_DIST_LONG
    fq10 = os.path.join(d, "dist.10kb.fq")
    write_fastq(fq10, reads[:n])
    tag = "10 dist 10kb"
    prefix = os.path.join(d, "dist.10kb.sam")
    reset_counts()
    t0 = time.perf_counter()
    valid, total = mapdist_cli(fa, fq10, n, prefix, prefix + ".log")
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    run = dist_launches()
    plain = plain_counts()
    walks = path_checks(("gact_walk",), raw=False)
    for k, v in run.items():
        counts[k] += v
    log(f"[{tag}] cli mapdist (world 1) of {n} reads of 10 kb in {t_map} s "
        f"= {n / t_map} reads/s end to end (index load included); launches "
        f"{json.dumps(run)}; global (valid, total) {(valid, total)}")
    with open(prefix + ".part0") as f:
        recs = parse_sam(f.read())
    with open(os.path.join(d, "10kb.sam")) as f:
        phase7 = parse_sam(f.read())[:n]
    differ = sum(a != b for a, b in zip(recs, phase7))
    log(f"[{tag}] records that differ from phase 7's SAM (half band + "
        f"full-band retry): {differ} of {n}")
    check_map(tag, prefix + ".part0", prefix + ".log", n, lpos, g, 100, [
        lambda b, r, c: (run["band_scores"] > 0 and run["band_dp_wide"] > 0,
                         f"launches {run}: band_scores and band_dp_wide > "
                         "0"),
        lambda b, r, c: (plain == 0, f"plain DP / scores / gact_forward "
                                     f"calls on CUDA {plain} == 0"),
        lambda b, r, c: (valid == sum(x[1] in ("0", "16") for x in recs)
                         and total == n,
                         f"global (valid, total) {(valid, total)} counts "
                         "the part's mapped records")] + as_extra(walks))

    # the seed vote's cost over ShardedRows (masked gather + all_reduce a
    # table) against the replicated tables, one world-1 group
    _, _, formed = init_distributed("cuda")
    try:
        mesh = make_mesh(1, 1, "cuda")
        arrays, meta, mta = load_host_index(fa, verbose=False)
        for name, shard in (("replicated", False), ("sharded", True)):
            idx = shard_index(arrays, mesh, shard, "cuda")
            st = stage_times(fa, stage_reads, chunk_b=2048, device="cuda",
                             traced_steps=0, index=(idx, meta, mta))
            st.pop("trace")
            log(f"[10 dist stages {name}] " + json.dumps(st))
            del idx
    finally:
        if formed:
            dist.destroy_process_group()

    # warmup: the first chunk's dispatch in a fresh process, after `cli
    # warmup --lengths 1024` and without it; both SAMs equal phase 4's
    for warm in ("0", "1"):
        sam = os.path.join(d, f"warm{warm}.sam")
        r = subprocess.run([sys.executable, "-c", WARM_MAP, HERE, fa, fq,
                            str(n_reads), warm, sam], capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"warmup run failed:\n{r.stderr[-3000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        with open(sam) as f:
            same = f.read() == ref
        log(f"[10 dist warmup] {'after cli warmup' if warm == '1' else 'cold'}"
            f": {json.dumps(res)}")
        log(f"[10 dist warmup] check {'PASS' if same else 'FAIL'}: SAM "
            "byte-identical to phase 4's")
        if not same:
            raise AssertionError("phase 10 failed: the map after warmup "
                                 "differs")
    return counts


def phase_fmi(fa: str, seed: int) -> None:
    """Phase 11a: the host FM-index queries against the suffix array and
    the .lch that phase 4 built on the card."""
    import numpy as np
    from longreadmapper_tpu_torch.index.fmi import FMIndex, encode_bytes
    from longreadmapper_tpu_torch.index.sa import sa_load
    prefix = fa + ".cat"
    rng = np.random.default_rng(seed + 11)
    fmi = FMIndex.read(prefix)
    checks = [(np.array_equal(sa_load(prefix), fmi.sa),
               "sa_load equals FMIndex.read's SA")]
    n = fmi.length
    t0 = time.perf_counter()
    fmi._full_rank()
    log(f"[11 tools] _full_rank (n = {n}) in {time.perf_counter() - t0} s, "
        f"{fmi._rank.nbytes} host bytes")
    rows = rng.integers(0, n, N_TOOL_ROWS)
    got = np.array([fmi.csa_access(int(i)) for i in rows])
    bail = int(np.count_nonzero((got == 0) & (fmi.sa[rows] != 0)))
    checks += [
        (bool(np.all((got == fmi.sa[rows]) | (got == 0))),
         f"csa_access(i) == SA[i] for {N_TOOL_ROWS} random rows, but for "
         f"the walk's bail-outs to 0 after 5 * csa_ratio steps"),
        (bail <= N_TOOL_ROWS // 100, f"bail-outs {bail} <= 1% of rows "
                                     "((3/4)^21 = 0.24% expected)")]
    # the .lch table (uint64 (k, l) pairs after a 12-byte header), read
    # where the queries land
    with open(prefix + ".lch", "rb") as f:
        hlen = int(np.frombuffer(f.read(4), "<i4")[0])
    lch = np.memmap(prefix + ".lch", dtype="<u8", mode="r", offset=12,
                    shape=(1 << (2 * hlen), 2))
    cat = encode_bytes(np.fromfile(prefix, dtype=np.uint8))
    place = 4 ** np.arange(hlen - 1, -1, -1)      # a k-mer's id, base 4
    starts = rng.integers(0, n - 1 - 32, 4 * N_TOOL_ROWS)
    starts = starts[[bool((cat[s:s + 32] < 4).all()) for s in starts]]
    kmers = np.concatenate([
        cat[starts[:N_TOOL_ROWS, None] + np.arange(hlen)],
        rng.integers(0, 4, (N_TOOL_ROWS, hlen)).astype(np.uint8)])
    ids = kmers.astype(np.int64) @ place
    t0 = time.perf_counter()
    res = [fmi.fmi_aln(q) for q in kmers]
    t_aln = time.perf_counter() - t0
    want = np.array([(k, l) if h else (0, 0) for h, k, l in res])
    found = sum(h > 0 for h, _, _ in res)
    checks.append((np.array_equal(np.asarray(lch[ids]).astype(np.int64),
                                  want),
                   f"the card-built .lch entry equals fmi_aln's (k, l) for "
                   f"{len(kmers)} {hlen}-mers ({N_TOOL_ROWS} from the "
                   f"genome, {N_TOOL_ROWS} random; {found} found)"))
    log(f"[11 tools] fmi_aln: {1e6 * t_aln / len(kmers)} us a {hlen}-mer "
        "query")
    # lc_aln: the last hlen bases by the table, the rest by fmi_aln
    lens = rng.integers(20, 33, N_TOOL_ROWS // 2)
    queries = [cat[s:s + m].copy() for s, m in zip(starts[N_TOOL_ROWS:],
                                                    lens)]
    for q in queries[::2]:
        q[rng.integers(0, len(q))] ^= 1 + rng.integers(0, 3)
    same = hits = 0
    t0 = time.perf_counter()
    for q in queries:
        m = len(q)
        k, l = (int(x) for x in lch[int(q[m - hlen:].astype(np.int64)
                                        @ place)])
        r1, k1, l1 = ((0, k, l) if (k, l) == (0, 0)
                      else fmi.fmi_aln(q[:m - hlen], k, l))
        r2, k2, l2 = fmi.fmi_aln(q)
        same += r1 == r2 and (r1 == 0 or (k1, l1) == (k2, l2))
        hits += r2 > 0
    us = 1e6 * (time.perf_counter() - t0) / len(queries)
    log(f"[11 tools] lc_aln + fmi_aln: {us} us a query pair of 20-32 bases")
    checks.append((same == len(queries),
                   f"lc_aln equals fmi_aln for {same} of {len(queries)} "
                   f"queries of 20-32 bases ({hits} found)"))
    for ok, what in checks:
        log(f"[11 tools] check {'PASS' if ok else 'FAIL'}: {what}")
    if not all(ok for ok, _ in checks):
        raise AssertionError("phase 11 failed: the FM-index queries")


def phase_tools(d: str, fa: str, fq: str, g, seed: int,
                ref_launches: int) -> int:
    """Phase 11: the FM-index queries (phase_fmi); TorchMapper.map_stream
    on the card against phase 4's SAM (and its band_dp launches,
    ref_launches) and beside map_stream_sam; the Myers aligners rescoring
    its records.  Returns map_stream's band_dp launches."""
    import numpy as np
    import torch
    from longreadmapper_tpu_torch import native
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch.index.fmi import encode_bytes
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    from longreadmapper_tpu_torch.runtime.reads import (chunks,
                                                        load_read_batches)
    from longreadmapper_tpu_torch.utils.config import Params
    phase_fmi(fa, seed)

    with open(os.path.join(d, "out.sam")) as f:
        ref = [l for l in f.read().splitlines(True) if not l.startswith("@")]
    reads = next(iter(load_read_batches(fq, N_READS, background=False)))
    mapper = TorchMapper(*load_device_index(fa, "cuda", verbose=False),
                         Params(batch_size=N_READS), chunk_b=2048,
                         device="cuda")

    def run(kind):
        t0 = time.perf_counter()
        if kind == "map_stream":
            out = [r for c in mapper.map_stream(chunks(reads, mapper.B))
                   for r in c]
        else:
            out = "".join(t for t, _, _ in mapper.map_stream_sam(
                chunks(reads, mapper.B)))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run("map_stream_sam")                  # the mapper's first chunks
    reset_counts()
    recs, t_stream = run("map_stream")
    launches, plain = banded_nw_dirs.launches, plain_counts()
    walks = path_checks(("walk_c",))
    sam, t_sam = run("map_stream_sam")
    log(f"[11 tools] map_stream {len(reads) / t_stream} reads/s, "
        f"map_stream_sam {len(reads) / t_sam} reads/s ({len(reads)} 1 kb "
        "reads, the stream alone, one process)")
    checks = [
        ([r.to_sam() for r in recs] == ref,
         f"map_stream's {len(recs)} records spell phase 4's SAM lines, in "
         "order"),
        (sam == "".join(ref), "map_stream_sam's SAM equals phase 4's"),
        (launches == ref_launches,
         f"band_dp launches of map_stream {launches} == phase 4's "
         f"{ref_launches}"),
        (plain == 0, f"plain DP calls on CUDA {plain} == 0")] + walks

    # the Myers aligners over the card's alignments: the NW distance
    # against the record's reference span, and the HW path in a window
    # 64 bases wider each side, bounded by the record's ED
    valid = [r for r in recs if r.valid]
    pairs = []
    for r in valid:
        span = sum(int(c) for c, op in re.findall(r"(\d+)([MID])", r.cigar)
                   if op in "MD")
        pairs.append((encode_bytes(np.frombuffer(r.seq.encode(), np.uint8)),
                      r.off, span, r.ed))
    t0 = time.perf_counter()
    nw = [native.myers_distance(q, g[off:off + span], "NW")[0]
          for q, off, span, _ in pairs]
    t_nw = time.perf_counter() - t0
    t0 = time.perf_counter()
    hw = [native.myers_align(q, g[max(off - 64, 0):off + span + 64], "HW",
                             k=ed) for q, off, span, ed in pairs]
    t_hw = time.perf_counter() - t0
    eds = np.array([p[3] for p in pairs])
    nw = np.array(nw)
    hw_ed = np.array([h[0] for h in hw])
    as_recs = [[r.qname, "0", "chr1",
                str(max(off - 64, 0) + h[1] + 1), "0",
                "".join(f"{c}{op}" for c, op in h[3]), "*", "0", "0",
                r.seq, "*", f"ED:I:{h[0]}"]
               for r, (_, off, _, _), h in zip(valid, pairs, hw)]
    bad = bad_alignments(as_recs, g)
    log(f"[11 tools] myers_distance NW {len(pairs) / t_nw} pairs/s, "
        f"myers_align HW (k = ED) {len(pairs) / t_hw} pairs/s; NW distance "
        f"equal to ED {int((nw == eds).sum())}, lower "
        f"{int((nw < eds).sum())} (the band bound the card's optimum); HW "
        f"lower than ED {int((hw_ed < eds).sum())}")
    checks += [
        (bool((nw <= eds).all()) and bool((nw >= 0).all()),
         f"myers_distance NW <= ED for all {len(pairs)} valid records"),
        (bool((hw_ed >= 0).all()) and bool((hw_ed <= eds).all()),
         "myers_align HW within k = ED for every record"),
        (bad == 0, f"myers_align paths that miss the read's length or "
                   f"the distance {bad} == 0")]
    for ok, what in checks:
        log(f"[11 tools] check {'PASS' if ok else 'FAIL'}: {what}")
    if not all(ok for ok, _ in checks):
        raise AssertionError("phase 11 failed")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "longreadmapper_tpu_torch")):
        print("chip_smoke.py: longreadmapper_tpu_torch/ is not beside this "
              "file; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches

    clock = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        log(f"[{phase}] phase done in {now - clock[0]} s")
        clock[0] = now

    card = phase_device()
    done("1 device")
    phase_build()
    done("2 build")
    kres = phase_kernel(args.seed)
    done("3 kernel")
    with tempfile.TemporaryDirectory(prefix="lrm_smoke_") as d:
        fa, fq, pos, g, launches = phase_map(d, args.seed, N_READS)
        done("4 map")
        long_data = {}
        for k, name in enumerate(LONG_SETS):
            n, read_len, _ = LONG_SETS[name]
            reads, lpos, hi = make_long_reads(g, args.seed + 1 + k, n,
                                              read_len)
            write_fastq(os.path.join(d, f"{name}.fq"), reads)
            write_fastq(os.path.join(d, f"{name}.cpu.fq"),
                        [reads[i] for i in CPU_LONG[name]])
            long_data[name] = (reads, lpos, hi)
        kres.update(phase_vote(d, fa, fq, long_data, args.seed))
        done("3b vote")
        kres.update(phase_glue(fa, fq, long_data))
        done("3c glue")
        fq_short = os.path.join(d, "short.cpu.fq")
        with open(fq) as f, open(fq_short, "w") as o:
            for _ in range(4 * N_CPU_READS):
                o.write(f.readline())
        sets = [("1kb", fq_short, N_CPU_READS, N_CPU_READS)] + [
            (name, os.path.join(d, f"{name}.cpu.fq"), len(CPU_LONG[name]),
             2048) for name in LONG_SETS]
        procs, texts = cpu_maps(d, fa, sets)
        try:
            done("5 cpu, card maps (the CPU maps run beside phases 6-7)")
            stage_reads = next(iter(load_read_batches(
                fq, N_STAGE_READS, background=False)))
            phase_stages("6 stages", fa, stage_reads)
            done("6 stages")
            counts = {"band_dp_wide": 0, "band_scores": 0}
            for name, (reads, lpos, hi) in long_data.items():
                for k, v in phase_long(d, fa, g, name, reads, lpos,
                                       hi).items():
                    counts[k] += v
                done(f"7 long {name}")
            check_cpu_maps(sets, procs, texts)
            done("5 cpu, the CPU maps checked")
        finally:
            stop(procs)
        with open(os.path.join(d, "out.sam")) as f:
            refs = {"1kb": (fq, N_READS, 2048, f.read())}
        for name in long_data:
            refs[name] = (os.path.join(d, f"{name}.cpu.fq"),
                          len(CPU_LONG[name]), 2048, texts[name])
        phase_layouts(d, fa, refs, pos, g, stage_reads)
        done("8 layouts")
        phase_index(d, fa, fq, pos, g, args.seed)
        done("9 index")
        reads10, lpos10, _ = long_data["10kb"]
        dist_counts = phase_dist(d, fa, fq, N_READS, pos, g,
                                 (reads10, lpos10), stage_reads)
        done("10 dist")
        launches += phase_tools(d, fa, fq, g, args.seed, launches)
        done("11 tools")
    launches = dict(band_dp=launches, **counts, **MAIN_LAUNCHES)
    for k, v in dist_counts.items():
        launches[k] += v
    src = {"band_dp": "band_dp.cu", "band_dp_wide": "band_dp.cu",
           "band_scores": "band_scores.cu", "walk_c": "walk.cu",
           "gact_walk": "walk.cu", "seed_tables": "vote.cu",
           "vote_rows": "vote.cu", **{k: "step.cu" for k in GLUE_KERNELS}}
    # the walks and the seed vote replace XLA loops, gathers and sorts,
    # not pallas_calls
    replaces = {"band_dp": "longreadmapper_tpu/ops/band_pallas.py:102",
                "band_dp_wide": "longreadmapper_tpu/ops/band_pallas.py:102",
                "band_scores":
                    "longreadmapper_tpu/ops/wavefront_pallas.py:95",
                "walk_c": "longreadmapper_tpu/ops/traceback.py:73 (an XLA "
                          "while_loop, not a pallas_call)",
                "gact_walk": "longreadmapper_tpu/ops/gact.py:276 (an XLA "
                             "while_loop in a scan, not a pallas_call)",
                "seed_tables": "longreadmapper_tpu/mapping/pipeline.py:362 "
                               "_position_tables and the lchash gather of "
                               ":581 (an XLA gather, not a pallas_call)",
                "vote_rows": "longreadmapper_tpu/mapping/pipeline.py:690 "
                             "and longreadmapper_tpu/ops/vote.py:56 "
                             "top2_votes, and the accept of "
                             "longreadmapper_tpu/mapping/pipeline.py:"
                             "768-796 (an XLA gather/sort and small ops, "
                             "not a pallas_call)",
                # the step glue: XLA fusions in the jitted step, no
                # pallas_call
                "encode": "longreadmapper_tpu/mapping/pipeline.py:1055-1067"
                          " raw_step's encode (XLA fusion, not a "
                          "pallas_call)",
                "locate_window": "longreadmapper_tpu/mapping/pipeline.py:"
                                 "798-820 _seq_lookup and :844-880 the "
                                 "strand select and target window (XLA "
                                 "fusion in _body, not a pallas_call)",
                "lanes": "longreadmapper_tpu/mapping/pipeline.py:907-909, "
                         "975-977, 989 ed, band_short, alive, lens_tb (XLA "
                         "fusion in _body, not a pallas_call)",
                "pack": "longreadmapper_tpu/mapping/pipeline.py:989-1050 "
                        "meta, pad sort, blob and tail (XLA fusion and "
                        "sort in _body, not a pallas_call)"}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"longreadmapper_tpu_torch/csrc/{src[k]}",
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kres[k]["err"], "ms": kres[k]["ms"],
        "plain_ms": kres[k]["plain_ms"], "bound_ms": kres[k]["bound_ms"],
        "bound_by": kres[k]["bound_by"], "library_ms": None}
        for k in src]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
