"""TorchMapper — the end-to-end mapping model of the port (counterpart of
longreadmapper_tpu/models/mapper.py::TPUMapper).

Bundles the device-resident DeviceIndex with the mapping step (one config
per read-length bucket) and the host post-processing (CIGAR decode + SAM).
A chunk part whose reads all have one length ships as raw ASCII and is
encoded on the device (pipeline.raw_map_step, the JAX mapper's raw
variant); ragged parts and every retry tier are encoded on the host.
`map_stream` yields each chunk's MapRecords, `map_stream_sam` its SAM
text, both through one stream of at most three chunks in flight: each
loop turn submits chunk c, issues chunk c-1's overflow retry (its copies
queued behind an event) and then finishes and assembles chunk c-2, so the
card runs c's first pass and c-1's retry while the host assembles.

Under a ('data', 'model') mesh (parallel/) the mapper is one rank of ONE
logical mapper: chunks are GLOBAL batches, each rank maps its own rows of
every part through parallel/dist.sharded_map_step, and the sensitivity
counter is a collective.  As in JAX's mesh mode every part is encoded on
the host and runs exact slots at the full band, so no read needs the
vote-overflow (bit 0) or narrow-band (bit 2) retry.  Unlike JAX, a chunk
whose gact run buffer saturated (bit 1) still re-runs through the 4x tier
(ROADMAP.md section C).

Defined-behaviour choices shared with the JAX package and its oracle:
unmapped reads (flag 0x4) emit CIGAR '*' and ED:I:-1; lookup failures
emit RNAME '*'.
"""

from __future__ import annotations

import ctypes
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import pick_device
from ..formats.fastx import _encode_lut
from ..formats.sam import sam_record
from ..index.device import DeviceIndex, IndexMeta
from ..mapping.pipeline import (MapperConfig, map_step, raw_map_step,
                                vote_classes)
from ..ops.vote import pow2_at_least
from .. import native_build
from ..utils.config import Params
from ..utils.trace import Span


@dataclass
class MapRecord:
    qname: str
    flag: int
    rname: str
    off: int          # 0-based; SAM POS = off + 1
    mapq: int
    cigar: str
    seq: str
    qual: str
    ed: int
    valid: bool

    def to_sam(self) -> str:
        return sam_record(self.qname, self.flag, self.rname, self.off,
                          self.mapq, self.cigar, self.seq, self.qual, self.ed)


_COMP_STR = str.maketrans("ACGTacgt", "TGCATGCA")


def revcomp(s: str) -> str:
    """Reverse complement, lowercase to UPPER complement (the oracle's)."""
    return s.translate(_COMP_STR)[::-1]


_CIGAR = {"lrm_cigar_batch": ([ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p], ctypes.c_int64)}


class _Cigars:
    """Each row's CIGAR string of a part's run bytes ((count << 2) | op
    entries of `entry_bytes` signed little-endian bytes, in reverse path
    order; "" for a row without runs), built by one call to
    csrc/cigar.cpp over the whole buffer.  The text buffer is kept, and
    grown, across calls."""

    def __init__(self):
        self._text = np.empty(0, np.uint8)
        self._ends = np.empty(0, np.int64)

    def __call__(self, runs: np.ndarray, entry_bytes: int) -> List[str]:
        if runs.ndim != 2 or runs.dtype.itemsize != 1:
            raise ValueError(f"run bytes expected, got {runs.dtype} "
                             f"{runs.shape}")
        if entry_bytes not in (1, 2, 4):
            raise ValueError(f"entry_bytes {entry_bytes}")
        B, width = runs.shape
        if B == 0:
            return []
        if runs.strides[1] != 1 or runs.strides[0] < width:
            runs = np.ascontiguousarray(runs)
        cap = B * (width // entry_bytes) * 11
        if self._text.size < cap:
            self._text = np.empty(cap, np.uint8)
        if self._ends.size < B:
            self._ends = np.empty(B, np.int64)
        lib = native_build.load("cigar", _CIGAR)
        used = lib.lrm_cigar_batch(runs.ctypes.data, B, width,
                                   runs.strides[0], entry_bytes,
                                   self._text.ctypes.data, cap,
                                   self._ends.ctypes.data)
        if used < 0:
            raise RuntimeError(f"lrm_cigar_batch failed on a ({B}, {width}) "
                               f"buffer of {entry_bytes}-byte entries")
        text = self._text[:used].tobytes().decode("ascii")
        ends = self._ends[:B].tolist()
        return [text[a:b] for a, b in zip([0] + ends[:-1], ends)]


def _widen_entries(ops: np.ndarray, src: int, dst: int) -> np.ndarray:
    """Run bytes of src-byte entries as bytes of dst-byte entries with the
    same values.  Only int16 -> int32 occurs: a retry tier's entries are
    never wider than its first pass's (the full band moves the 10 kb
    bucket from resident int32 to gact int16, never the other way)."""
    if src == dst:
        return ops
    assert (src, dst) == (2, 4), (src, dst)
    w = ops.shape[1] - ops.shape[1] % 2
    return np.ascontiguousarray(ops[:, :w]).view(np.int16).astype(
        np.int32).view(np.int8)


def _tail_needed(ops: np.ndarray, entry_bytes: int) -> bool:
    """True when some read's runs reach the last eager head slot (the
    lazily fetched tail may hold more): the last entry's op bits are not
    the pad op."""
    if ops.shape[1] < entry_bytes:
        return True
    return bool((np.asarray(ops[:, -entry_bytes]) & 3 != 3).any())


def _bucket_len(n: int, minimum: int = 128) -> int:
    """Round a read length up to a bucket: powers of two to 1K, then 1K
    steps."""
    b = minimum
    while b < n and b < 1024:
        b *= 2
    if b < n:
        b = -(-n // 1024) * 1024
    return b


class TorchMapper:
    def __init__(self, idx, meta: IndexMeta, mta, params: Params,
                 chunk_b: int = 0, device="cuda", mesh=None,
                 shard_tables: bool = False):
        """A single-device mapper over `idx`, a DeviceIndex on `device`;
        or, when `mesh` is given, this rank's part of one mapper over the
        mesh: `idx` is then the host arrays (index.device.load_host_index)
        that parallel/dist.shard_index places, replicated or (with
        shard_tables) row-sharded over 'model', and B is rounded up to a
        multiple of the 'data' axis."""
        self.device = pick_device(device)
        self.mesh = mesh
        self.meta = meta
        self.mta = list(mta)
        self.params = params
        self.B = chunk_b or params.chunk_size
        self.n_data, self.data_index = 1, 0
        if mesh is not None:
            from ..parallel.dist import shard_index
            self.n_data = mesh["data"].size()
            self.data_index = mesh.get_coordinate()[0]
            self.B = -(-self.B // self.n_data) * self.n_data
            idx = shard_index(idx, mesh, shard_tables, self.device)
        if idx.packed.device != self.device:
            raise ValueError(f"index on {idx.packed.device}, mapper on "
                             f"{self.device}")
        self.idx = idx
        self._cfgs = {}
        self._retry_cfgs = {}
        self._sat_cfgs = {}
        self._wide_cfgs = {}
        self.overflow_reads = 0   # reads whose final meta carries a flag
        self.retried_reads = 0    # reads re-run through the exact tier
        self.retry_steps = 0      # exact-tier steps issued for them
        # of those, the reads whose vote needs more slots than the tier's
        # step has, re-run through a wide vote class step (_retry_overflow),
        # the class steps issued for them, and the reads a class step still
        # left with bit 0
        self.wide_vote_reads = 0
        self.wide_vote_steps = 0
        self.wide_vote_unresolved = 0
        # of those, the steps whose wait came after a stage of another
        # chunk (a submit, an issue, a finish): the stream's overlap.
        # _stage_seq counts the stages run; a step issued at one count
        # and waited on at a larger one was deferred.
        self.deferred_retry_steps = 0
        self._stage_seq = 0
        self.retried_sat_chunks = 0   # gact chunks re-walked, 4x run buffer
        self.raw_chunks = 0       # chunk parts encoded on the device
        self.host_chunks = 0      # chunk parts encoded on the host (ragged)
        # mapped reads of all ranks, from the mesh's collective counter
        self.valid_global = 0
        self.submitted_chunks = 0  # a chunk's ordinal in its spans
        self._cigars = _Cigars()
        # Seconds of the stream.  Host wall clock, each timed by a span of
        # the same block (utils/trace.py): prepare = read packing
        # (mapper.prepare); dispatch = H2D staging + the step's issue
        # (mapper.dispatch; enqueued: the step makes no host sync); fetch
        # = waiting for a part's D2H copy and the lazy tail copy
        # (mapper.fetch); retry = both retry tiers, packing, issue, wait
        # and splice (mapper.retry_saturation, mapper.retry_overflow: the
        # overflow tier's issue, mapper.retry.finish: its wait and
        # splice); retry_wait = the waits for the retry steps' copies, a
        # part of retry (mapper.retry.wait); wide_vote = the issue of the
        # wide vote class steps, a part of retry (mapper.retry.wide);
        # assemble = SAM building (mapper.assemble); cigar = its CIGAR
        # strings, a part of assemble (mapper.assemble.cigar).  Device
        # time by CUDA events (0 on the CPU), each read after a wait the
        # stream makes anyway: first_pass_device = a part's first pass,
        # its H2D copies to its blob's D2H copy; retry_device = a retry
        # step, its H2D copies to its last kernel; wide_vote_device = the
        # class steps' part of retry_device.
        self.phase_s = {"prepare": 0.0, "dispatch": 0.0, "fetch": 0.0,
                        "retry": 0.0, "retry_wait": 0.0, "wide_vote": 0.0,
                        "assemble": 0.0, "cigar": 0.0,
                        "first_pass_device": 0.0,
                        "retry_device": 0.0, "wide_vote_device": 0.0}

    # ------------------------------------------------------------ configs

    def _b_for(self, L: int) -> int:
        """Global batch per bucket: scaled down for reads above 1 kb, and a
        multiple of the 'data' axis under a mesh."""
        if L <= 1024:
            return self.B
        b = max(8, (self.B * 1024 // L) // 8 * 8)
        return max(self.n_data, -(-b // self.n_data) * self.n_data)

    def _local_rows(self, B: int) -> tuple[int, int]:
        """This rank's contiguous rows [lo, hi) of a global batch of B
        (all of them without a mesh)."""
        share = B // self.n_data
        return self.data_index * share, (self.data_index + 1) * share

    def _step_for(self, L: int) -> MapperConfig:
        """The config of bucket L's first pass, at this rank's share of the
        bucket's global batch."""
        if L not in self._cfgs:
            cfg = MapperConfig.from_params(self.params, self.meta,
                                           self._b_for(L), L)
            if self.mesh is not None:
                # the retry tiers of bits 0 and 2 are a host-local affair:
                # the mesh runs exact slots at the full band
                cfg = replace(cfg, B=cfg.B // self.n_data, exact_slots=True,
                              short_W_override=0)
            elif L > cfg.gact_threshold:
                # long buckets' first pass at half band on both long paths
                # (half_band: gact, short_W_override: resident); lanes
                # with ed >= W/2 flag bit 2 for the full-band retry
                cfg = replace(cfg, half_band=True,
                              short_W_override=max(64, cfg.W // 2))
            self._cfgs[L] = cfg
        return self._cfgs[L]

    def _retry_step_for(self, L: int) -> MapperConfig:
        """Exact-everything config (full vote budget, full band) for
        reads flagged with vote overflow (bit 0) or a narrow-band ed
        (bit 2), at a batch of at most 256."""
        if L not in self._retry_cfgs:
            cfg = self._step_for(L)
            self._retry_cfgs[L] = replace(cfg, B=min(cfg.B, 256),
                                          exact_slots=True, half_band=False,
                                          short_W_override=0)
        return self._retry_cfgs[L]

    # the vote scratch a wide vote class step may take (16 bytes a slot of
    # each of its rows bounds the kernels' pairs and staged seeds, and the
    # plain vote's per-slot temporaries)
    WIDE_VOTE_BYTES = 256 << 20

    def _wide_step_for(self, L: int, slots: int, B: int) -> MapperConfig:
        """The retry tier's config at `slots` vote slots a row and a batch
        of B: a wide vote class step.  Its pick keeps every wide seed of
        its reads (wide_budget), so no row holds fewer votes than its
        read's vote_need counts; it takes its tier's align path (tiled
        gact where the tier's step is), so its run entries splice as the
        tier's do."""
        key = (L, slots, B)
        if key not in self._wide_cfgs:
            cfg = self._retry_step_for(L)
            self._wide_cfgs[key] = replace(cfg, B=B, vote_budget=slots,
                                           wide_budget=B * cfg.npos,
                                           tiled=cfg.use_gact)
        return self._wide_cfgs[key]

    def _wide_batch(self, L: int, slots: int) -> int:
        """The most reads a class step of `slots` slots takes: a power of
        2 whose rows' scratch fits WIDE_VOTE_BYTES, at least 1, at most
        the tier's batch."""
        cfg = self._retry_step_for(L)
        fit = self.WIDE_VOTE_BYTES // (16 * slots * cfg.phases)
        return min(cfg.B, 1 << max(0, int(fit).bit_length() - 1))

    def _sat_step_for(self, L: int) -> MapperConfig:
        """4x-run-buffer gact config for chunks whose shared run buffer
        saturated (bit 1)."""
        if L not in self._sat_cfgs:
            cfg = self._step_for(L)
            assert cfg.use_gact
            self._sat_cfgs[L] = replace(cfg, gact_runs_scale=4)
        return self._sat_cfgs[L]

    def bucket_configs(self) -> List[dict]:
        """The first-pass shape of every bucket mapped so far: B, the path
        (resident directions or tiled gact), its W and band, the run-entry
        width."""
        out = []
        for L, cfg in sorted(self._cfgs.items()):
            W, band = ((cfg.gact_W, cfg.gact_band) if cfg.use_gact
                       else (cfg.short_W, cfg.short_band))
            out.append(dict(L=L, B=cfg.B,
                            path="gact" if cfg.use_gact else "resident",
                            W=W, band=band, entry_bytes=cfg.tb_entry_bytes))
        return out

    def warmup(self, lengths: Sequence[int] = (256, 1024)) -> float:
        """Pay the first-use costs of the buckets of `lengths` before a
        stream: build the CUDA kernels (native_build), then run once on
        the device every step variant that _prepare_chunk and the retry
        tiers can dispatch for each bucket, as JAX's warmup compiles them:
        host-encoded, raw (single device), the exact-everything retry
        (where the first pass is compact or narrow) and, where the first
        pass is compact, one wide vote class step of a read at the tier's
        widest class.  Each runs on a part of pad rows, which loads its
        kernels' modules and fills the allocator's pools; no counter of
        the mapper moves.  Returns the elapsed seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            native_build.build(names=("band_dp", "band_scores", "walk",
                                      "vote", "step"))
        for L in sorted({_bucket_len(int(n)) for n in lengths}):
            cfg = self._step_for(L)
            variants = [(cfg, False)]
            if self.mesh is None:
                variants.append((cfg, True))
                if not cfg.exact_slots and (
                        cfg.vote_slots < cfg.vote_slots_exact
                        or cfg.half_band):
                    cfg_r = self._retry_step_for(L)
                    variants.append((cfg_r, False))
                    if cfg.vote_slots < cfg.vote_slots_exact:
                        variants.append((self._wide_step_for(
                            L, cfg_r.vote_slots_max, 1), False))
            for c, raw in variants:
                codes = (np.zeros((c.B, L), np.uint8) if raw
                         else np.full((c.B, L), 4, np.int8))
                lens = np.zeros(c.B, np.int32)
                self._run_step(c, codes, None if raw else codes, lens, lens)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------ packing

    def _limits(self, lens: np.ndarray) -> np.ndarray:
        # (int)(ERROR_RATE*len*2) in C double semantics
        return ((self.params.error_rate * lens.astype(np.float64)) * 2
                ).astype(np.int32)

    def _pack_reads(self, part, L: int, n_pack: int):
        """Encode up to n_pack (name, seq, qual) reads: (codes, codes_rc,
        lens, limits) numpy arrays, the reverse complement front-aligned
        and everything padded with code 4."""
        lut = _encode_lut().view(np.int8)
        clut = lut.copy()
        clut[lut < 4] = 3 - lut[lut < 4]   # complement; N stays 4
        lens = np.zeros(n_pack, dtype=np.int32)
        n_part = len(part)
        codes = np.full((n_pack, L), 4, dtype=np.int8)
        codes_rc = np.full((n_pack, L), 4, dtype=np.int8)
        if n_part > 0 and all(len(s) == len(part[0][1]) for _, s, _ in part):
            L0 = len(part[0][1])
            raw = np.frombuffer("".join(s for _, s, _ in part).encode(),
                                np.uint8).reshape(n_part, L0)
            lens[:n_part] = L0
            codes[:n_part, :L0] = lut[raw]
            codes_rc[:n_part, :L0] = clut[raw][:, ::-1]
        else:
            for i, (_, seq, _) in enumerate(part):
                raw = np.frombuffer(seq.encode(), np.uint8)
                lens[i] = raw.shape[0]
                codes[i, :raw.shape[0]] = lut[raw]
                codes_rc[i, :raw.shape[0]] = clut[raw[::-1]]
        return codes, codes_rc, lens, self._limits(lens)

    def _pack_raw(self, part, L: int, n_pack: int):
        """Raw bytes of a uniform-length part for the device encode:
        (raw, None, lens, limits), the None marking the raw variant."""
        L0 = len(part[0][1])
        raw = np.zeros((n_pack, L), dtype=np.uint8)
        raw[:len(part), :L0] = np.frombuffer(
            "".join(p[1] for p in part).encode(),
            np.uint8).reshape(len(part), L0)
        lens = np.zeros(n_pack, dtype=np.int32)
        lens[:len(part)] = L0
        return raw, None, lens, self._limits(lens)

    def _prepare_chunk(self, reads):
        """Host-side packing (numpy) of up to B reads into parts of the
        bucket's global batch: raw bytes for a part of one read length,
        else host codes.  Under a mesh `reads` is the GLOBAL chunk, so
        every rank agrees on the bucket, and each rank packs only its own
        rows of each part (pad rows where they hold no read: the rank
        still runs the step, whose collectives its peers wait on)."""
        n_real = len(reads)
        assert n_real <= self.B
        L = _bucket_len(max((len(s) for _, s, _ in reads), default=1))
        cfg = self._step_for(L)
        Bg = cfg.B * self.n_data
        lo, hi = self._local_rows(Bg)
        prepped = []
        for s in range(0, max(n_real, 1), Bg):
            part = reads[s + lo:s + hi]
            if (self.mesh is None and part
                    and all(len(p[1]) == len(part[0][1]) for p in part)):
                prepped.append((part,) + self._pack_raw(part, L, cfg.B))
            else:
                prepped.append((part,) + self._pack_reads(part, L, cfg.B))
        return L, prepped

    # ------------------------------------------------------- device steps

    def _h2d(self, *arrays, chunk=None):
        """numpy -> device tensors; through pinned memory with
        non-blocking copies on the current stream when on CUDA."""
        with Span("mapper.h2d", chunk):
            if self.device.type == "cpu":
                return [torch.from_numpy(a) for a in arrays]
            return [torch.from_numpy(a).pin_memory().to(self.device,
                                                        non_blocking=True)
                    for a in arrays]

    def _event(self):
        """A timing CUDA event recorded on the current stream; None on the
        CPU."""
        if self.device.type == "cpu":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _run_step(self, cfg: MapperConfig, codes, codes_rc, lens, limits,
                  chunk=None):
        """The step of one packed part; `codes_rc` None marks raw bytes
        (_pack_raw), whose read length is known here on the host.  Runs
        map_step on the mapper's index: under a sharded mesh every rank
        of the model group must make the same calls."""
        if codes_rc is None:
            draw, dl, dlim = self._h2d(codes, lens, limits, chunk=chunk)
            with Span("mapper.step", chunk):
                return raw_map_step(cfg, self.idx, draw, dl, dlim,
                                    int(lens.max()))
        dc, drc, dl, dlim = self._h2d(codes, codes_rc, lens, limits,
                                      chunk=chunk)
        with Span("mapper.step", chunk):
            return map_step(cfg, self.idx, dc, drc, dl, dlim)

    def _start_d2h(self, out: dict, chunk=None, tail: bool = False) -> dict:
        """Queue the blob's and the vote need's D2H copies into pinned
        memory on the current CUDA stream (non-blocking) and record an
        event to wait on.  The CIGAR tail stays on the device until a read
        needs it; with `tail` (a retry step's) it is copied too, behind the
        same event, the need is not (only a first pass's sizes a retry),
        and the result holds no device tensor."""
        with Span("mapper.d2h", chunk):
            if self.device.type == "cpu":
                return dict(blob=out["blob"], ops_tail=out["ops_tail"],
                            need=None if tail else out["vote_need"],
                            event=None)

            def pinned(t):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                return h

            return dict(blob=pinned(out["blob"]),
                        ops_tail=(pinned(out["ops_tail"]) if tail
                                  else out["ops_tail"]),
                        need=None if tail else pinned(out["vote_need"]),
                        event=self._event())

    @staticmethod
    def _split_blob(cfg: MapperConfig, blob: np.ndarray):
        mb = 4 * cfg.meta_words
        return np.ascontiguousarray(blob[:, :mb]).view(np.int32), blob[:, mb:]

    def _dispatch_chunk(self, prepared, chunk=None):
        """Issue the step of each part of a prepared chunk and queue its
        D2H copy: (cfg, reads, lens, out) a part, `out` holding the host
        blob, the device tail, the copy's event, the event the part's
        first pass starts at and the chunk's ordinal."""
        L, prepped = prepared
        cfg = self._step_for(L)
        parts = []
        for part, codes, codes_rc, lens, limits in prepped:
            if codes_rc is None:
                self.raw_chunks += 1
            else:
                self.host_chunks += 1
            start = self._event()
            if self.mesh is None:
                out = self._run_step(cfg, codes, codes_rc, lens, limits,
                                     chunk)
                valid = None
            else:
                from ..parallel.dist import sharded_map_step
                step = sharded_map_step(cfg, self.mesh)
                arrays = self._h2d(codes, codes_rc, lens, limits,
                                   chunk=chunk)
                with Span("mapper.step", chunk):
                    out, valid = step(self.idx, *arrays)
            parts.append((cfg, part, lens,
                          dict(self._start_d2h(out, chunk), valid=valid,
                               start=start, chunk=chunk)))
        return parts

    def submit_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]):
        """Pack and run the device step for up to B reads."""
        k = self.submitted_chunks
        self.submitted_chunks += 1
        self._stage_seq += 1
        with Span("mapper.prepare", k, self.phase_s, "prepare"):
            prepared = self._prepare_chunk(reads)
        with Span("mapper.dispatch", k, self.phase_s, "dispatch"):
            return self._dispatch_chunk(prepared, k)

    def _fetch_chunk(self, pending):
        """The issue stage of a submitted chunk: for each part, wait for
        its D2H copy, fetch the CIGAR tail only when some read's runs reach
        the end of the eager head, run the saturation tier, then issue the
        overflow tier's steps (_retry_overflow).  Nothing here waits for an
        overflow step: _finish_chunk does."""
        self._stage_seq += 1
        fetched = []
        for cfg, reads, lens, out in pending:
            k = out["chunk"]
            with Span("mapper.fetch", k, self.phase_s, "fetch"):
                if out["event"] is not None:
                    out["event"].synchronize()
                    self.phase_s["first_pass_device"] += \
                        out["start"].elapsed_time(out["event"]) / 1e3
                if out["valid"] is not None:
                    self.valid_global += int(out["valid"])
                meta, ops = self._split_blob(cfg, out["blob"].numpy())
                if _tail_needed(ops, cfg.tb_entry_bytes):
                    ops = np.concatenate(
                        [ops, out["ops_tail"].cpu().numpy()], axis=1)
            res = self._retry_saturation(
                cfg, reads, dict(meta=meta, ops=ops, chunk=k,
                                 need=out["need"].numpy()), k)
            res = self._retry_overflow(cfg, reads, res, k)
            fetched.append((cfg, reads, lens, res))
        return fetched

    def _finish_chunk(self, fetched):
        """The finish stage of an issued chunk: wait for each part's
        overflow steps and splice their rows in (_finish_overflow)."""
        done = [(cfg, reads, lens, self._finish_overflow(cfg, out))
                for cfg, reads, lens, out in fetched]
        self._stage_seq += 1
        return done

    def _issue_step(self, cfg: MapperConfig, part, chunk=None) -> dict:
        """Run `cfg`'s step on the reads of `part` and queue its blob and
        tail copies into pinned memory behind one event: the record holds
        the host buffers and the step's start and end events, no device
        tensor.  Nothing waits here."""
        with Span("mapper.retry.pack", chunk):
            packed = self._pack_reads(part, cfg.L, cfg.B)
        start = self._event()
        o = self._run_step(cfg, *packed, chunk=chunk)
        end = self._event()
        return dict(self._start_d2h(o, chunk, tail=True), start=start,
                    end=end)

    def _finish_step(self, cfg: MapperConfig, rec: dict, chunk=None,
                     wide: bool = False):
        """Wait for an issued step's copies and return its (meta, ops) in
        full; the step's device time is read after the wait, and kept in
        wide_vote_device too for a wide vote class step (`wide`)."""
        with Span("mapper.retry.wait", chunk, self.phase_s, "retry_wait"):
            if rec["event"] is not None:
                rec["event"].synchronize()
            meta, ops = self._split_blob(cfg, rec["blob"].numpy())
            if ops.shape[1] and _tail_needed(ops, cfg.tb_entry_bytes):
                ops = np.concatenate([ops, rec["ops_tail"].numpy()], axis=1)
        if rec["start"] is not None:
            dt = rec["start"].elapsed_time(rec["end"]) / 1e3
            self.phase_s["retry_device"] += dt
            if wide:
                self.phase_s["wide_vote_device"] += dt
        return meta, ops

    def _retry_saturation(self, cfg: MapperConfig, reads, out, chunk=None):
        """Re-walk a gact chunk whose shared run buffer saturated (bit 1,
        ops/gact.gact_traceback_c) through the 4x-buffer tier, at once
        (the issue and the wait together).  The flag is chunk-wide (the
        clamped last buffer row may hold any lane's runs), so the whole
        chunk re-runs and its meta/ops are replaced; a flag that survives
        even 4x shows in overflow_reads.  Under a mesh a rank re-runs its
        own rows (JAX's mesh mode leaves the flag unrecovered): with a
        replicated index alone, with sharded tables together with its
        model group, whose ranks hold the same rows and so the same
        flag."""
        if not cfg.use_gact or not (
                out["meta"][:len(reads), cfg.meta_words - 1] & 2).any():
            return out
        with Span("mapper.retry_saturation", chunk, self.phase_s, "retry"):
            sat = self._sat_step_for(cfg.L)
            meta, ops = self._finish_step(
                sat, self._issue_step(sat, reads, chunk), chunk)
        self.retried_sat_chunks += 1
        return dict(out, meta=meta, ops=ops)

    def _retry_overflow(self, cfg: MapperConfig, reads, out, chunk=None):
        """Issue the exact-everything tier's steps for the reads flagged
        with vote overflow (bit 0) or a narrow-band ed (bit 2), at most
        the tier's B a step; their records and row selections ride in the
        part's `retry`, for _finish_overflow.  The bit-0 reads whose widest
        vote row (the first pass's need) passes the tier's slots take a
        wide vote class step instead: one step a part at the power-of-2
        class of its widest need (vote_classes), its batch padded to a
        power of 2 over those reads (_wide_batch bounds it).  Bit 1 (gact
        saturation) is not retried here: more vote slots cannot fix it."""
        if cfg.exact_slots:
            return out
        flags = out["meta"][:len(reads), cfg.meta_words - 1]
        flagged = np.flatnonzero(flags & 5)
        if flagged.size == 0:
            return out
        with Span("mapper.retry_overflow", chunk, self.phase_s, "retry"):
            cfg_r = self._retry_step_for(cfg.L)
            slots = vote_classes(out["need"][flagged], cfg_r.vote_slots)
            slots[(flags[flagged] & 1) == 0] = 0
            steps = []

            def issue(c, sel, wide=False):
                steps.append((c, sel, wide, self._issue_step(
                    c, [reads[i] for i in sel], chunk)))

            exact = flagged[slots == 0]
            for s in range(0, exact.size, cfg_r.B):
                issue(cfg_r, exact[s:s + cfg_r.B])
            wide = flagged[slots > 0]
            if wide.size:
                with Span("mapper.retry.wide", chunk, self.phase_s,
                          "wide_vote"):
                    c = int(slots.max())
                    bmax = self._wide_batch(cfg.L, c)
                    for s in range(0, wide.size, bmax):
                        sel = wide[s:s + bmax]
                        issue(self._wide_step_for(
                            cfg.L, c, min(bmax, pow2_at_least(sel.size))),
                            sel, True)
                        self.wide_vote_steps += 1
                self.wide_vote_reads += int(wide.size)
        self.retried_reads += int(flagged.size)
        self.retry_steps += len(steps)
        return dict(out, retry=steps, issued_at=self._stage_seq)

    def _finish_overflow(self, cfg: MapperConfig, out):
        """Wait for a part's issued overflow steps and splice their rows
        (meta with the real flag, run bytes) in, their run entries widened
        to the chunk's width, which the assembly decodes with.  A read a
        wide vote class step leaves with bit 0 counts in
        wide_vote_unresolved."""
        if "retry" not in out:
            return out
        k = out["chunk"]
        with Span("mapper.retry.finish", k, self.phase_s, "retry"):
            meta = out["meta"].copy()
            ops = np.asarray(out["ops"]).copy()
            for cfg_r, sel, wide, rec in out["retry"]:
                meta_r, ops_r = self._finish_step(cfg_r, rec, k, wide)
                if wide:
                    self.wide_vote_unresolved += int(
                        (meta_r[:sel.size, cfg_r.meta_words - 1] & 1).sum())
                ops_r = _widen_entries(ops_r, cfg_r.tb_entry_bytes,
                                       cfg.tb_entry_bytes)
                if ops_r.shape[1] > ops.shape[1]:
                    pad = np.full((ops.shape[0],
                                   ops_r.shape[1] - ops.shape[1]), 3, np.int8)
                    ops = np.concatenate([ops, pad], axis=1)
                meta[sel] = meta_r[:sel.size]
                ops[sel] = 3          # blank any leftover compact-tier bytes
                ops[sel, :ops_r.shape[1]] = ops_r[:sel.size]
        if self._stage_seq > out["issued_at"]:
            self.deferred_retry_steps += len(out["retry"])
        return dict(meta=meta, ops=ops, chunk=k)

    # ----------------------------------------------------------- assembly

    def _count_overflow(self, cfg, reads, out) -> None:
        self.overflow_reads += int(
            (out["meta"][:len(reads), cfg.meta_words - 1] != 0).sum())

    def _assemble(self, done) -> List[MapRecord]:
        k = done[0][3]["chunk"]
        recs: List[MapRecord] = []
        with Span("mapper.assemble", k, self.phase_s, "assemble"):
            for cfg, reads, lens, out in done:
                self._count_overflow(cfg, reads, out)
                recs.extend(self._postprocess(cfg, reads, lens, out, k))
        return recs

    def _assemble_sam(self, done) -> Tuple[str, int, int]:
        k = done[0][3]["chunk"]
        text, total, valid = [], 0, 0
        with Span("mapper.assemble", k, self.phase_s, "assemble"):
            for cfg, reads, lens, out in done:
                self._count_overflow(cfg, reads, out)
                t, v = self._postprocess_sam(cfg, reads, lens, out, k)
                text.append(t)
                total += len(reads)
                valid += v
        return "".join(text), total, valid

    def collect_chunk(self, pending) -> List[MapRecord]:
        """The MapRecords of a submitted chunk."""
        return self._assemble(self._finish_chunk(self._fetch_chunk(pending)))

    def map_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]
                  ) -> List[MapRecord]:
        """Map up to B reads: (name, seq, qual) tuples -> MapRecords."""
        return self.collect_chunk(self.submit_chunk(reads))

    def collect_chunk_sam(self, pending) -> Tuple[str, int, int]:
        """(sam_text, n_records, n_valid) for a submitted chunk."""
        return self._assemble_sam(
            self._finish_chunk(self._fetch_chunk(pending)))

    def _stream(self, chunk_iter, assemble):
        """assemble(finished chunk) per chunk, in order.  A loop turn
        submits chunk c, issues chunk c-1 (its first-pass copy landed
        while c-2's retry ran; its overflow steps now queue behind c's
        first pass) and finishes and assembles chunk c-2: at most three
        chunks in flight, and the card holds c's first pass and c-1's
        retry through c-2's assembly.  At the end the remaining chunks are
        issued, then finished, in order."""
        submitted, issued = deque(), deque()
        for chunk in chunk_iter:
            submitted.append(self.submit_chunk(chunk))
            if len(submitted) > 1:
                issued.append(self._fetch_chunk(submitted.popleft()))
            if len(issued) > 1:
                yield assemble(self._finish_chunk(issued.popleft()))
        while submitted:
            issued.append(self._fetch_chunk(submitted.popleft()))
        while issued:
            yield assemble(self._finish_chunk(issued.popleft()))

    def map_stream(self, chunk_iter):
        """List[MapRecord] per chunk of an iterator of read chunks."""
        return self._stream(chunk_iter, self._assemble)

    def map_stream_sam(self, chunk_iter):
        """SAM text per chunk, (sam_text, n_records, n_valid)."""
        return self._stream(chunk_iter, self._assemble_sam)

    _COMP = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")

    @staticmethod
    def _meta_cols(cfg: MapperConfig, meta: np.ndarray):
        """(found, gi, strand, off, ed) columns of either meta layout."""
        if cfg.pos64:
            # [best_lo, best_hi, found, gi, strand, off_lo, off_hi, ed,
            #  limit, overflow]
            off = ((meta[:, 6].astype(np.int64) << 32)
                   | meta[:, 5].astype(np.uint32).astype(np.int64))
            return (meta[:, 2] != 0, meta[:, 3], meta[:, 4] != 0, off,
                    meta[:, 7])
        return (meta[:, 1] != 0, meta[:, 2], meta[:, 3] != 0, meta[:, 4],
                meta[:, 5])

    def _postprocess_sam(self, cfg: MapperConfig, reads, lens, out,
                         chunk=None) -> Tuple[str, int]:
        """Chunk-vectorized SAM assembly, one f-string per record."""
        found, gi, strand, off, ed = self._meta_cols(cfg, out["meta"])
        n = len(reads)
        with Span("mapper.assemble.cigar", chunk, self.phase_s, "cigar"):
            cigs = self._cigars(np.asarray(out["ops"][:n]),
                                cfg.tb_entry_bytes)
        with Span("mapper.assemble.records", chunk):
            valid_l = (found & (ed >= 0))[:n].tolist()
            strand_l = strand[:n].tolist()
            found_l = found[:n].tolist()
            pos_l = (off + 1)[:n].tolist()
            ed_l = ed[:n].tolist()
            gi_l = gi[:n].tolist()
            names = [m.seq_name for m in self.mta]
            comp = self._COMP
            lines = []
            ap = lines.append
            n_valid = 0
            for i, (name, seq, qual) in enumerate(reads):
                q = qual if qual else "*"
                if valid_l[i]:
                    n_valid += 1
                    flag = 16 if strand_l[i] else 0
                    if strand_l[i]:
                        seq = seq.encode().translate(comp)[::-1].decode()
                    ap(f"{name}\t{flag}\t{names[gi_l[i]]}\t{pos_l[i]}\t255\t"
                       f"{cigs[i] or '*'}\t*\t0\t0\t{seq}\t{q}\t"
                       f"ED:I:{ed_l[i]}\n")
                elif found_l[i]:
                    if strand_l[i]:
                        seq = seq.encode().translate(comp)[::-1].decode()
                    ap(f"{name}\t4\t{names[gi_l[i]]}\t{pos_l[i]}\t0\t*\t*\t0"
                       f"\t0\t{seq}\t{q}\tED:I:-1\n")
                else:
                    ap(f"{name}\t4\t*\t1\t0\t*\t*\t0\t0\t{seq}\t{q}"
                       f"\tED:I:-1\n")
            return "".join(lines), n_valid

    def _postprocess(self, cfg: MapperConfig, reads, lens, out,
                     chunk=None) -> List[MapRecord]:
        found, gi, strand, off, ed = self._meta_cols(cfg, out["meta"])
        with Span("mapper.assemble.cigar", chunk, self.phase_s, "cigar"):
            cigs = self._cigars(np.asarray(out["ops"][:len(reads)]),
                                cfg.tb_entry_bytes)
        recs: List[MapRecord] = []
        with Span("mapper.assemble.records", chunk):
            for i, (name, seq, qual) in enumerate(reads):
                ok = bool(found[i])
                ed_i = int(ed[i]) if ok else -1
                valid = ok and ed_i >= 0
                if valid:
                    cig = cigs[i] or "*"
                    flag = 16 if strand[i] else 0
                    mapq = 255
                else:
                    cig, flag, mapq = "*", 0x4, 0
                recs.append(MapRecord(
                    qname=name, flag=flag,
                    rname=self.mta[int(gi[i])].seq_name if ok else "*",
                    off=int(off[i]) if ok else 0, mapq=mapq, cigar=cig,
                    seq=revcomp(seq) if (ok and strand[i]) else seq,
                    qual=qual if qual else "*", ed=ed_i, valid=valid))
        return recs
