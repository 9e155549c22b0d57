"""Where the mapping step's time goes: per-stage times of `map_step` and,
on CUDA, a `torch.profiler` trace of the device kernels.  The stages are
the seed vote's four (SEED_VOTE_STAGES: seed_tables, the per-seed tables
and lchash gather, one kernel on CUDA; narrow, the wide seeds' rank;
vote_rows, the pick, the (read, phase) rows' votes and each read's
accept, one kernel on CUDA; accept, empty since the accept joined the
vote's launch; `seed_vote_ms` is their sum), locate_window, then those of the branch the bucket takes (resident:
band_dp, walk; gact: gact_forward, gact_walk), after `encode` where the
chunk ships raw bytes (pipeline.raw_map_step).  On CUDA `walk` is one
launch of the column-walk kernel and `gact_walk` the tile groups'
direction kernel and walk kernel, one launch each a group
(csrc/band_dp.cu, csrc/walk.cu).

Each read chunk runs through `map_step` twice: once with a device sync
after every stage (host clock, so a stage's time includes its launches)
and once unsynced (the whole step).  The first chunk is a warm-up and is
not counted.  On CUDA, three more steps of the second chunk are traced;
the device's busy share is the kernels' summed time over the span from
the first kernel's start to the last one's end (the tracer itself widens
that span); `launches` counts the traced steps' device kernels by name.

  from longreadmapper_tpu_torch.runtime.stages import stage_times
  stage_times("ref.fa", reads, chunk_b=2048, device="cuda")
"""

from __future__ import annotations

import time
from collections import Counter

import torch

from ..index.device import load_device_index
from ..mapping.pipeline import map_step, raw_map_step
from ..models.mapper import TorchMapper
from ..utils.config import Params
from .reads import chunks

TRACED_STEPS = 3
SEED_VOTE_STAGES = ("seed_tables", "narrow", "vote_rows", "accept")


def _step(cfg, idx, codes, codes_rc, lens, limits, dev):
    """The step of one packed part (TorchMapper._prepare_chunk), its
    inputs uploaded once: a function of `mark`."""
    up = [torch.from_numpy(a).to(dev) for a in (codes, lens, limits)]
    if codes_rc is None:                          # raw bytes
        return lambda mark=None: raw_map_step(cfg, idx, *up, mark=mark)
    drc = torch.from_numpy(codes_rc).to(dev)
    return lambda mark=None: map_step(cfg, idx, up[0], drc, up[1], up[2],
                                      mark=mark)


def stage_times(genome_path: str, reads, chunk_b: int = 2048,
                device="cuda", traced_steps: int = TRACED_STEPS,
                index=None) -> dict:
    """Mean ms per chunk of each stage and of the whole step over
    `reads` (at least two chunks) at the default parameters (seed length
    20, threshold 300), plus the device trace of `traced_steps` steps on
    CUDA.  `index` is a loaded (idx, meta, mta) of `genome_path` in
    another layout, else its default layout is loaded."""
    idx, meta, mta = index or load_device_index(genome_path, device,
                                                verbose=False)
    mapper = TorchMapper(idx, meta, mta, Params(), chunk_b=chunk_b,
                         device=device)
    dev = mapper.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    steps = []
    for chunk in chunks(reads, mapper.B):
        L, prepped = mapper._prepare_chunk(chunk)
        for _, *arrays in prepped:
            steps.append((mapper._step_for(L),
                          _step(mapper._step_for(L), idx, *arrays, dev)))
    if len(steps) < 2:
        raise ValueError("stage_times needs at least two chunks of reads")

    stage_s: dict[str, float] = {}
    step_s = 0.0
    for i, (cfg, step) in enumerate(steps):
        sync()
        last = [time.perf_counter()]

        def mark(stage):
            sync()
            now = time.perf_counter()
            if i:
                stage_s[stage] = stage_s.get(stage, 0.0) + now - last[0]
            last[0] = now

        step(mark)
        t0 = time.perf_counter()
        step()
        sync()
        if i:
            step_s += time.perf_counter() - t0
    n = len(steps) - 1
    cfg = steps[1][0]
    # the first pass's band: half band on long buckets, gact or resident
    W, band = ((cfg.gact_W, cfg.gact_band) if cfg.use_gact
               else (cfg.short_W, cfg.short_band))
    stage_ms = {k: v / n * 1e3 for k, v in stage_s.items()}
    out = dict(timed_chunks=n, B=cfg.B, L=cfg.L,
               path="gact" if cfg.use_gact else "resident", W=W, band=band,
               vote_slots=cfg.vote_slots, max_seeds=cfg.max_seeds,
               stage_ms=stage_ms,
               seed_vote_ms=sum(stage_ms[k] for k in SEED_VOTE_STAGES),
               step_ms=step_s / n * 1e3, trace=None)
    if dev.type == "cuda" and traced_steps:
        out["trace"] = _trace(steps[1][1], traced_steps)
    return out


def _trace(step, n_steps: int) -> dict | None:
    """Device kernels of n_steps steps; None when the profiler sees no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not ev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in ev)
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev))
    per_name, launches = Counter(), Counter()
    for e in ev:
        per_name[e.name] += e.time_range.elapsed_us()
        launches[e.name[:80]] += 1
    return dict(steps=n_steps, kernels=len(ev), busy_ms=busy / 1e3,
                span_ms=span / 1e3, busy_share=busy / span,
                top_ms={k[:80]: v / 1e3 for k, v in per_name.most_common(6)},
                launches=dict(launches.most_common()))
