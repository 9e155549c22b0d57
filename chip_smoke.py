#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (longreadmapper_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels, holds each to its plain
PyTorch version, drives `cli index` + `cli map` on a bacterial-scale
reference with 1 kb, 10 kb and 50 kb reads, checks the SAM, and breaks the
mapping step's time down by stage.

  python3 chip_smoke.py [--seed N]

Phases (each raises on failure; nothing is caught):
  1. device  — requires CUDA; prints the card's name and power limit
  2. build   — nvcc builds csrc/band_dp.cu and csrc/band_scores.cu for
               sm_90a from this checkout, one nvcc each, in parallel, and
               prints each kernel's registers, stack and spills
  3. kernel  — each kernel against its plain version on the card,
               bit-equal at every listed shape; median times at the main
               shapes: band_dp (warp per read; band_dp_wide timed beside
               it at its four bands), band_dp_wide (resident and tile
               entry), band_scores (checkpoints, the long path's entry,
               and the full matrix)
  4. map     — a 4 Mb single-contig genome and 16384 1 kb reads (3%
               substitutions, both strands, planted positions), all made
               from --seed; `cli index` then `cli map` in-process; checks
               record count, validity, placement, that every CIGAR
               consumes its read and spells its ED against the genome,
               and that the main path went through the kernel and never
               through a plain version
  5. cpu     — `cli map --device cpu` (plain versions, in subprocesses)
               and `--device cuda` give byte-identical SAM: the first 256
               1 kb reads, 16 reads of the 10 kb set (2 high-error, so the
               full-band retry runs through gact at band 2176) and 2 reads
               of the 50 kb set
  6. stages  — per-stage times of the mapping step on the 1 kb reads and
               a torch.profiler trace of its device kernels
  7. long    — 800 reads of 10 kb and 160 of 50 kb on the phase-4 genome
               (3% substitutions + 0.5% 1-base insertions + 0.5% deletions;
               2% of the reads at 7% + 1%, past the half band), each set
               through `cli map --device cuda --chunk-b 2048`; checks as
               phase 4 plus the bucket configs, the bit-2 retries and the
               long-read kernels' launches; then per-stage times

The last stdout line is {"ok": true, "device": {...}}; the line before it
is the card's name and power limit, and the one before that the kernels'
JSON record.  Exits non-zero, printing no result, when CUDA is unavailable
or the port's package is not beside this file.
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
SCORES_1KB = (128, 1024, 102, 256)             # wavefront_pallas.py:6-8
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
    from longreadmapper_tpu_torch.ops import cuda_build
    cuda_build.build(force=True)
    for name, info in cuda_build.build_info.items():
        log(f"[2 build] nvcc sm_90a csrc/{name}.cu in {info['seconds']} s")
        kernel = None
        for line in info["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif "registers" in line or "stack frame" in line:
                log(f"[2 build]   {kernel}: {line.strip()}")


def dp_inputs(rng, B: int, L: int):
    """Reads mutated from seeded targets (3% substitutions, a few 1-base
    indels, ragged ends), plus all-pad rows; as CUDA tensors."""
    import numpy as np
    import torch
    t = rng.integers(0, 4, (B, L)).astype(np.int8)
    q = np.full((B, L), 4, np.int8)
    for b in range(B):
        s = t[b].copy()
        m = rng.random(L) < 0.03
        s[m] = (s[m] + 1 + rng.integers(0, 3, int(m.sum()))) % 4
        s = list(s)
        for _ in range(int(rng.integers(0, 4))):
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


def check_equal(kernel: str, where: str, got, want) -> int:
    """Raise unless every output is bit-equal; returns the max |diff|."""
    import torch
    torch.cuda.synchronize()
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{kernel} output {i} {tuple(g.shape)} "
                                 f"{g.dtype} vs {tuple(w.shape)} {w.dtype}")
        diff = int((g.long() - w.long()).abs().max())
        err = max(err, diff)
        if not torch.equal(g, w):
            raise AssertionError(f"{kernel} output {i} differs from the "
                                 f"plain version at {where} (max |diff| "
                                 f"{diff})")
    log(f"[3 kernel] {kernel} {where}: bit-equal to the plain version")
    return err


def phase_kernel(seed: int) -> dict:
    import numpy as np
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_wide,
                                                      banded_nw_dirs)
    from longreadmapper_tpu_torch.ops.band_scores import (band_checkpoints,
                                                          band_scores)
    from longreadmapper_tpu_torch.ops.gact import gact_forward
    from longreadmapper_tpu_torch.ops.wavefront import (banded_nw_dirs_v,
                                                        banded_nw_scores)

    rng = np.random.default_rng(seed)
    res = {k: dict(err=0, ms=None, plain_ms=None)
           for k in ("band_dp", "band_dp_wide", "band_scores")}

    def note(kernel, where, ms, plain_ms, main=False):
        log(f"[3 kernel] {kernel} {where} median: kernel {ms} ms, plain "
            f"PyTorch {plain_ms} ms ({plain_ms / ms}x)")
        if main:
            res[kernel].update(ms=ms, plain_ms=plain_ms)

    def err(kernel, e):
        res[kernel]["err"] = max(res[kernel]["err"], e)

    # band_dp, the warp-per-read kernel, at its four bands; band_dp_wide,
    # which takes these bands too, on the same inputs and timed beside it
    for B, L, W, band in SHAPES:
        q, t = dp_inputs(rng, B, L)
        where = f"B={B} L={L} W={W} band={band}"
        n0 = banded_nw_dirs.launches
        got = banded_nw_dirs(q, t, W, band)
        assert banded_nw_dirs.launches == n0 + 1
        want = banded_nw_dirs_v(q, t, W, band)
        err("band_dp", check_equal("band_dp", where, got, want))
        err("band_dp_wide", check_equal(
            "band_dp_wide", where, band_dp_wide(q, t, W, band, None, 0, L),
            want))
        del got, want
        ms = cuda_ms(lambda: banded_nw_dirs(q, t, W, band), 20)
        wide_ms = cuda_ms(lambda: band_dp_wide(q, t, W, band, None, 0, L),
                          20)
        log(f"[3 kernel] {where} median: band_dp {ms} ms, band_dp_wide "
            f"{wide_ms} ms ({wide_ms / ms}x)")
        if (B, L, W, band) == MAIN_SHAPE:
            note("band_dp", where, ms,
                 cuda_ms(lambda: banded_nw_dirs_v(q, t, W, band), 3), True)

    # band_dp_wide, resident mode: the whole pass from row 0
    for B, L, W, band in WIDE_SHAPES:
        q, t = dp_inputs(rng, B, L)
        where = f"resident B={B} L={L} W={W} band={band}"
        n0 = band_dp_wide.launches
        got = banded_nw_dirs(q, t, W, band)
        assert band_dp_wide.launches == n0 + 1
        want, plain_ms = timed_once(lambda: banded_nw_dirs_v(q, t, W, band))
        err("band_dp_wide", check_equal("band_dp_wide", where, got, want))
        del got, want
        if (B, L, W, band) == WIDE_MAIN:
            note("band_dp_wide", where,
                 cuda_ms(lambda: banded_nw_dirs(q, t, W, band), 5),
                 plain_ms, True)

    # band_scores checkpoints and band_dp_wide tile mode, entered from the
    # plain forward pass's checkpoint row TILE_K
    B, L, T = TILE_B, TILE_L, TILE_T
    for W, band in TILE_BANDS:
        q, t = dp_inputs(rng, B, L)
        where = f"checkpoints B={B} L={L} W={W} band={band} T={T}"
        want, plain_ms = timed_once(lambda: gact_forward(q, t, T, W, band))
        err("band_scores", check_equal(
            "band_scores", where, band_checkpoints(q, t, T, W, band), want))
        if (W, band) == TILE_BANDS[0]:      # the 50 kb forward pass
            note("band_scores", where,
                 cuda_ms(lambda: band_checkpoints(q, t, T, W, band), 5),
                 plain_ms, True)
        h0 = want[0][TILE_K].contiguous()
        i0 = TILE_K * T
        where = f"tile B={B} L={L} W={W} band={band} rows {i0}+{T}"
        n0 = band_dp_wide.launches
        got = banded_nw_dirs(q, t, W, band, h0=h0, i0=i0, n=T)
        assert band_dp_wide.launches == n0 + 1
        want_t, plain_ms = timed_once(
            lambda: banded_nw_dirs_v(q, t, W, band, h0=h0, i0=i0, n=T))
        err("band_dp_wide", check_equal("band_dp_wide", where, got, want_t))
        note("band_dp_wide", where, cuda_ms(
            lambda: banded_nw_dirs(q, t, W, band, h0=h0, i0=i0, n=T), 10),
            plain_ms)
        del want, got, want_t

    # band_scores, the full score matrix
    for B, L, W, band in SCORES_SHAPES:
        q, t = dp_inputs(rng, B, L)
        where = f"full B={B} L={L} W={W} band={band}"
        got = band_scores(q, t, W, band)
        want, plain_ms = timed_once(lambda: banded_nw_scores(q, t, W, band))
        err("band_scores", check_equal("band_scores", where, [got], [want]))
        del got, want
        if (B, L, W, band) == SCORES_1KB:
            note("band_scores", where,
                 cuda_ms(lambda: band_scores(q, t, W, band), 20),
                 cuda_ms(lambda: banded_nw_scores(q, t, W, band), 3))
    return res


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
            chunk_b: int = 0):
    """`cli map` in-process, SAM to `sam`, its verbose log to `log_path`."""
    from longreadmapper_tpu_torch import cli
    with open(sam, "w") as f, open(log_path, "w") as e, \
            contextlib.redirect_stdout(f), contextlib.redirect_stderr(e):
        cli.main(map_argv(fa, fq, n, device, chunk_b or min(n, 2048)))


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
    checks = [
        (len(recs) == n_reads, f"records {len(recs)} == {n_reads}"),
        (len(valid) >= 0.99 * n_reads,
         f"valid {len(valid)} >= 0.99 * {n_reads}"),
        (near >= 0.99 * len(valid),
         f"within {tol} bp of planted {near} >= 0.99 * {len(valid)}"),
        (bad == 0, f"CIGARs that miss the read's length or the ED {bad} "
                   "== 0"),
    ] + [c(buckets, retried) for c in extra]
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
    and the walks' host syncs to 0; the peak memory statistic too."""
    import torch
    from longreadmapper_tpu_torch.ops.band_dp import (band_dp_wide,
                                                      banded_nw_dirs)
    from longreadmapper_tpu_torch.ops.band_scores import band_scores
    from longreadmapper_tpu_torch.ops.gact import (gact_forward,
                                                   gact_traceback_c)
    from longreadmapper_tpu_torch.ops.traceback import device_traceback_c
    from longreadmapper_tpu_torch.ops.wavefront import (banded_nw_dirs_v,
                                                        banded_nw_scores)
    for fn in (banded_nw_dirs, band_dp_wide, band_scores):
        fn.launches = 0
    for fn in (banded_nw_dirs_v, banded_nw_scores, gact_forward):
        fn.cuda_calls = 0
    device_traceback_c.host_syncs = gact_traceback_c.host_syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def walk_syncs() -> int:
    from longreadmapper_tpu_torch.ops.gact import gact_traceback_c
    from longreadmapper_tpu_torch.ops.traceback import device_traceback_c
    return device_traceback_c.host_syncs + gact_traceback_c.host_syncs


def phase_map(d: str, seed: int, n_reads: int, genome_len: int = 4_000_000):
    import torch
    from longreadmapper_tpu_torch import cli
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs

    t0 = time.perf_counter()
    fa, fq, pos, g = make_data(d, seed, genome_len, n_reads, 1000, 0.03)
    log(f"[4 map] data made in {time.perf_counter() - t0} s "
        f"({genome_len} bp genome, {n_reads} reads of 1 kb, 3% "
        "substitutions)")
    t0 = time.perf_counter()
    cli.main(["index", fa, "--quiet"])
    log(f"[4 map] cli index (hlen by auto_hlen) in "
        f"{time.perf_counter() - t0} s")

    sam = os.path.join(d, "out.sam")
    map_log = os.path.join(d, "map.log")
    reset_counts()
    t0 = time.perf_counter()
    map_cli(fa, fq, n_reads, "cuda", sam, map_log)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    launches, plain = banded_nw_dirs.launches, plain_counts()
    log(f"[4 map] cli map in {t_map} s = {n_reads / t_map} reads/s "
        "end to end (index load included)")
    log(f"[4 map] walk host syncs {walk_syncs()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    check_map("4 map", sam, map_log, n_reads, pos, g, 16, [
        lambda b, r: (launches > 0, f"band_dp kernel launches {launches} "
                                    "> 0"),
        lambda b, r: (plain == 0, f"plain DP calls on CUDA {plain} == 0")])
    return fa, fq, g, launches


def phase_cpu(d: str, fa: str, sets):
    """sets: (name, fq, n_reads, chunk_b).  The CPU maps run as
    subprocesses, all at once, while the card maps the same reads."""
    import torch
    threads = max(1, len(os.sched_getaffinity(0)) // 2)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = []
    try:
        for name, fq, n, cb in sets:
            sam = os.path.join(d, f"{name}.cpu.sam")
            with open(sam, "w") as f, open(sam + ".log", "w") as e:
                procs.append((name, sam, time.perf_counter(), subprocess.Popen(
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
        for (name, fq, n, cb), (_, sam, t0, p) in zip(sets, procs):
            rc = p.wait()
            log(f"[5 cpu] {name}: cli map of {n} reads on cpu ({threads} "
                f"threads) in {time.perf_counter() - t0} s, exit {rc}")
            if rc != 0:
                with open(sam + ".log") as f:
                    raise RuntimeError(f"cpu map of {name} failed:\n"
                                       + f.read()[-3000:])
            with open(sam) as f:
                cpu = f.read()
            same = cpu == texts[name] and len(parse_sam(cpu)) == n
            log(f"[5 cpu] check {'PASS' if same else 'FAIL'}: {name}: SAM "
                f"of {n} reads byte-identical between the CPU (plain "
                f"versions) and the card ({len(cpu)} bytes)")
            if not same:
                raise AssertionError("phase 5 failed")
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_stages(tag: str, fa: str, reads, traced_steps: int = 3):
    from longreadmapper_tpu_torch.runtime.stages import stage_times

    st = stage_times(fa, reads, chunk_b=2048, device="cuda",
                     traced_steps=traced_steps)
    trace = st.pop("trace")
    log(f"[{tag}] " + json.dumps(st))
    log(f"[{tag}] trace " + (json.dumps(trace) if trace else
                             "not measured: the profiler saw no device "
                             "kernels"))


def phase_long(d: str, fa: str, g, name: str, reads, pos, hi) -> dict:
    import torch
    from longreadmapper_tpu_torch.ops.band_dp import band_dp_wide
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
    counts = dict(band_dp_wide=band_dp_wide.launches,
                  band_scores=band_scores.launches)
    plain = plain_counts()
    n_hi = int(hi.sum())
    log(f"[{tag}] cli map of {n} reads of {read_len} bp in {t_map} s = "
        f"{n / t_map} reads/s, {n * read_len / t_map / 1e6} Mb/s end to end "
        "(index load included)")
    log(f"[{tag}] launches {json.dumps(counts)}, walk host syncs "
        f"{walk_syncs()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30} GiB")
    # both sets launch both kernels: at 10 kb the first pass is resident
    # (band_dp_wide) and the full-band retry takes gact (band_scores, then
    # band_dp_wide tiles); at 50 kb every pass is gact
    check_map(tag, sam, sam + ".log", n, pos, g, max(16, read_len // 100), [
        lambda b, r: (b == [want_cfg], f"bucket configs {b} == "
                                       f"[{want_cfg}]"),
        lambda b, r: (r is not None and r >= n_hi,
                      f"retried reads {r} >= high-error reads {n_hi}"),
        lambda b, r: (min(counts.values()) > 0,
                      f"band_dp_wide and band_scores launches {counts} > 0"),
        lambda b, r: (plain == 0, f"plain DP / scores / gact_forward calls "
                                  f"on CUDA {plain} == 0")])
    phase_stages(tag, fa, [(nm, s, None) for nm, s in reads], 1)
    return counts


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
        fa, fq, g, launches = phase_map(d, args.seed, N_READS)
        done("4 map")
        long_data = {}
        for k, name in enumerate(LONG_SETS):
            n, read_len, _ = LONG_SETS[name]
            reads, pos, hi = make_long_reads(g, args.seed + 1 + k, n,
                                             read_len)
            write_fastq(os.path.join(d, f"{name}.fq"), reads)
            write_fastq(os.path.join(d, f"{name}.cpu.fq"),
                        [reads[i] for i in CPU_LONG[name]])
            long_data[name] = (reads, pos, hi)
        fq_short = os.path.join(d, "short.cpu.fq")
        with open(fq) as f, open(fq_short, "w") as o:
            for _ in range(4 * N_CPU_READS):
                o.write(f.readline())
        phase_cpu(d, fa, [("1kb", fq_short, N_CPU_READS, N_CPU_READS)] + [
            (name, os.path.join(d, f"{name}.cpu.fq"), len(CPU_LONG[name]),
             2048) for name in LONG_SETS])
        done("5 cpu")
        phase_stages("6 stages", fa, next(iter(load_read_batches(
            fq, N_STAGE_READS, background=False))))
        done("6 stages")
        counts = {"band_dp_wide": 0, "band_scores": 0}
        for name, (reads, pos, hi) in long_data.items():
            for k, v in phase_long(d, fa, g, name, reads, pos,
                                   hi).items():
                counts[k] += v
            done(f"7 long {name}")
    launches = dict(counts, band_dp=launches)
    src = {"band_dp": "band_dp.cu", "band_dp_wide": "band_dp.cu",
           "band_scores": "band_scores.cu"}
    replaces = {"band_dp": "longreadmapper_tpu/ops/band_pallas.py:102",
                "band_dp_wide": "longreadmapper_tpu/ops/band_pallas.py:102",
                "band_scores":
                    "longreadmapper_tpu/ops/wavefront_pallas.py:95"}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"longreadmapper_tpu_torch/csrc/{src[k]}",
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kres[k]["err"], "ms": kres[k]["ms"],
        "plain_ms": kres[k]["plain_ms"]} for k in src]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
