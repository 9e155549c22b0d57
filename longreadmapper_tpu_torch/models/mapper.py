"""TorchMapper — the end-to-end mapping model of the port (counterpart of
longreadmapper_tpu/models/mapper.py::TPUMapper).

Bundles the device-resident DeviceIndex with the mapping step (one config
per read-length bucket) and the host post-processing (CIGAR decode + SAM).
On a single device every step's part, ragged or not, first pass and
retry tiers alike, ships as raw ASCII rows and is encoded on the device
at each row's own length (pipeline.raw_map_step, the JAX mapper's raw
variant); only a mesh's parts are encoded on the host.
`map_stream` yields each chunk's MapRecords, `map_stream_sam` its SAM
text, both through one stream of at most three chunks in flight: each
loop turn submits chunk c, issues chunk c-1's overflow retry (its copies
queued behind an event) and then finishes and assembles chunk c-2, so the
card runs c's first pass and c-1's retry while the host assembles.  Each
part of a chunk rides the stream as one _Part record; each step comes
back to the host as a _Step through one read-back (_read_back).

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
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
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


# reverse complement: lowercase to UPPER complement (the oracle's)
_COMP = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")


@dataclass(slots=True, eq=False)
class _Step:
    """A step's output on its way to the host (TorchMapper._read_back):
    blob (meta words, the runs' eager head) and tail, and a first pass's
    vote need; `copied` is the event after the copies, `start`..`end` the
    step's device time (events None on the CPU).  An overflow step also
    has its part's rows (`sel`) and whether it is a wide vote class step."""
    cfg: MapperConfig
    blob: torch.Tensor
    tail: torch.Tensor
    need: Optional[torch.Tensor]
    copied: Optional[torch.cuda.Event]
    start: Optional[torch.cuda.Event]
    end: Optional[torch.cuda.Event]
    sel: Optional[np.ndarray] = None
    wide: bool = False


@dataclass(slots=True, eq=False)
class _Part:
    """A chunk part through the stream, updated in place by each stage:
    dispatched (`first`; under a mesh `valid`, the collective count),
    fetched (`meta`, `ops` of `eb`-byte entries, `need`; its overflow
    steps `retry`, issued at stage `issued_at`), finished (the steps
    spliced into meta and ops, `eb` the widest of their entries)."""
    cfg: MapperConfig
    reads: Sequence[Tuple[str, str, Optional[str]]]
    chunk: Optional[int]
    first: Optional[_Step]
    valid: Optional[torch.Tensor] = None
    meta: Optional[np.ndarray] = None
    ops: Optional[np.ndarray] = None
    eb: int = 0
    need: Optional[np.ndarray] = None
    retry: List[_Step] = field(default_factory=list)
    issued_at: int = 0


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
    same values: int16 -> int32, or as they are.  A splice widens
    whichever side is narrower, in either direction: the retry's rows
    where the first pass's entries are wider (the 10 kb bucket: a resident
    int32 first pass, a gact int16 retry), the first pass's rows where the
    retry's are (past ~80 kb: a gact int16 first pass, an int32
    full-band retry)."""
    if src == dst:
        return ops
    assert (src, dst) == (2, 4), (src, dst)
    w = ops.shape[1] - ops.shape[1] % 2
    return np.ascontiguousarray(ops[:, :w]).view(np.int16).astype(
        np.int32).view(np.int8)


def _joined(part) -> Optional[np.ndarray]:
    """The bases of a part whose reads all have one length L0, as one (n,
    L0) uint8 array; None for a ragged or empty part."""
    if not part or any(len(s) != len(part[0][1]) for _, s, _ in part):
        return None
    return np.frombuffer("".join(s for _, s, _ in part).encode(),
                         np.uint8).reshape(len(part), len(part[0][1]))


def _host_codes(part, L: int, n_pack: int):
    """Up to n_pack (name, seq, qual) reads encoded on the host: (codes,
    codes_rc, lens), the codes (n_pack, L) int8, the reverse complement
    front-aligned and everything padded with code 4."""
    raw = _joined(part)
    lut = _encode_lut().view(np.int8)
    clut = lut.copy()
    clut[lut < 4] = 3 - lut[lut < 4]   # complement; N stays 4
    lens = np.zeros(n_pack, dtype=np.int32)
    codes = np.full((n_pack, L), 4, dtype=np.int8)
    codes_rc = np.full((n_pack, L), 4, dtype=np.int8)
    if raw is not None:
        n, L0 = raw.shape
        lens[:n] = L0
        codes[:n, :L0] = lut[raw]
        codes_rc[:n, :L0] = clut[raw][:, ::-1]
    else:
        for i, (_, seq, _) in enumerate(part):
            b = np.frombuffer(seq.encode(), np.uint8)
            lens[i] = b.shape[0]
            codes[i, :b.shape[0]] = lut[b]
            codes_rc[i, :b.shape[0]] = clut[b[::-1]]
    return codes, codes_rc, lens


def _raw_rows(part, L: int, n_pack: int):
    """Up to n_pack reads' bytes for the device encode, zero-padded to
    (n_pack, L) uint8, and their lens: a part of one length is one join
    and reshape (_joined), a ragged one a slice copy a read; no per-base
    work."""
    out = np.zeros((n_pack, L), dtype=np.uint8)
    lens = np.zeros(n_pack, dtype=np.int32)
    raw = _joined(part)
    if raw is not None:
        n, L0 = raw.shape
        out[:n, :L0] = raw
        lens[:n] = L0
    else:
        for i, (_, seq, _) in enumerate(part):
            b = np.frombuffer(seq.encode(), np.uint8)
            lens[i] = b.shape[0]
            out[i, :b.shape[0]] = b
    return out, lens


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
        # packed steps, first passes and retry steps alike, whose reads
        # were encoded on the device (raw bytes: every step on a single
        # device) or on the host (host codes: a mesh's)
        self.raw_chunks = 0
        self.host_chunks = 0
        # of those, the steps that took the tiled gact path, and of them
        # the steps whose run entries are int32 (MapperConfig.tb_entry_bytes:
        # reads past ~80 kb)
        self.gact_steps = 0
        self.int32_gact_steps = 0
        # mapped reads of all ranks, from the mesh's collective counter
        self.valid_global = 0
        self.submitted_chunks = 0  # a chunk's ordinal in its spans
        self._cigars = _Cigars()
        self._names = [m.seq_name for m in self.mta]
        # Seconds of the stream.  Host wall clock, each timed by a span of
        # the same block (utils/trace.py): prepare = read packing
        # (mapper.prepare); retry_pack = the retry steps' packing, a part
        # of retry (mapper.retry.pack); dispatch = H2D staging + the
        # step's issue (mapper.dispatch; enqueued: the step makes no host
        # sync); fetch = a part's first-pass read-back (mapper.fetch);
        # retry = both retry tiers, packing, issue, wait and splice
        # (mapper.retry_saturation, mapper.retry_overflow: the overflow
        # tier's issue, mapper.retry.finish: its wait and splice);
        # retry_wait = the retry steps' read-backs, a part of retry
        # (mapper.retry.wait); wide_vote = the issue of the wide vote class
        # steps, a part of retry (mapper.retry.wide); widen = the splice's
        # int16 -> int32 widening of run entries, a part of retry
        # (mapper.retry.widen); assemble = a
        # chunk's records (mapper.assemble); cigar = their CIGAR strings
        # (mapper.assemble.cigar).  Device time by CUDA events (0 on the
        # CPU), a _Step's start to end, read in _read_back after its wait:
        # first_pass_device = a first pass, its H2D copies to its blob's
        # D2H copy; retry_device = a retry step, its H2D copies to its
        # last kernel; wide_vote_device = the class steps' part of it.
        self.phase_s = {"prepare": 0.0, "dispatch": 0.0, "fetch": 0.0,
                        "retry": 0.0, "retry_pack": 0.0, "retry_wait": 0.0,
                        "wide_vote": 0.0, "widen": 0.0, "assemble": 0.0,
                        "cigar": 0.0,
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

    def _variants(self, L: int) -> List[MapperConfig]:
        """The config of every step a part of bucket L can take, each
        packed as _pack packs it: the first pass (_prepare_chunk); the
        exact tier where the first pass can flag a read for it (a compact
        vote, bit 0, or a narrow band, bit 2), and where its vote is
        compact one wide vote class step of a read at the tier's widest
        class (_retry_overflow)."""
        cfg = self._step_for(L)
        out = [cfg]
        compact = cfg.vote_slots < cfg.vote_slots_exact
        if not cfg.exact_slots and (compact or cfg.half_band):
            cfg_r = self._retry_step_for(L)
            out.append(cfg_r)
            if compact:
                out.append(self._wide_step_for(L, cfg_r.vote_slots_max, 1))
        return out

    def warmup(self, lengths: Sequence[int] = (256, 1024)) -> float:
        """Pay the first-use costs of the buckets of `lengths` before a
        stream, as JAX's warmup compiles them: build the CUDA kernels
        (native_build), then run each bucket's step variants (_variants)
        once on a part of no reads, which loads their kernels' modules and
        fills the allocator's pools; no counter moves.  Returns seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            native_build.build(names=("band_dp", "band_scores", "walk",
                                      "vote", "step"))
        for L in sorted({_bucket_len(int(n)) for n in lengths}):
            for c in self._variants(L):
                self._run_step(c, *self._pack([], L, c.B))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------ packing

    def _limits(self, lens: np.ndarray) -> np.ndarray:
        # (int)(ERROR_RATE*len*2) in C double semantics
        return ((self.params.error_rate * lens.astype(np.float64)) * 2
                ).astype(np.int32)

    def _pack(self, part, L: int, n_pack: int):
        """A part's step input: raw bytes (_pack_raw) on a single device,
        host codes (_pack_reads) under a mesh, whose sharded step takes
        codes."""
        if self.mesh is None:
            return self._pack_raw(part, L, n_pack)
        return self._pack_reads(part, L, n_pack)

    def _pack_reads(self, part, L: int, n_pack: int):
        """Up to n_pack reads encoded on the host (_host_codes): (codes,
        codes_rc, lens, limits)."""
        codes, codes_rc, lens = _host_codes(part, L, n_pack)
        return codes, codes_rc, lens, self._limits(lens)

    def _pack_raw(self, part, L: int, n_pack: int):
        """Up to n_pack reads' bytes for the device encode (_raw_rows):
        (raw, None, lens, limits), the None marking the raw variant."""
        raw, lens = _raw_rows(part, L, n_pack)
        return raw, None, lens, self._limits(lens)

    def _prepare_chunk(self, reads):
        """Host-side packing (numpy, _pack) of up to B reads into parts of
        the bucket's global batch.  Under a mesh `reads` is the GLOBAL
        chunk, so every rank agrees on the bucket, and each rank packs only
        its own rows of each part (pad rows where they hold no read: the rank
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
            prepped.append((part,) + self._pack(part, L, cfg.B))
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
        (_pack_raw), encoded on the device at each row's length.  Runs
        map_step on the mapper's index: under a sharded mesh every rank
        of the model group must make the same calls."""
        if codes_rc is None:
            draw, dl, dlim = self._h2d(codes, lens, limits, chunk=chunk)
            with Span("mapper.step", chunk):
                return raw_map_step(cfg, self.idx, draw, dl, dlim)
        dc, drc, dl, dlim = self._h2d(codes, codes_rc, lens, limits,
                                      chunk=chunk)
        with Span("mapper.step", chunk):
            return map_step(cfg, self.idx, dc, drc, dl, dlim)

    def _start_d2h(self, cfg: MapperConfig, out: dict, start, end=None,
                   chunk=None) -> _Step:
        """Queue a step's D2H copies behind one event, non-blocking on the
        current stream (into pinned memory, which a non-blocking copy from
        the card allocates; on the CPU the tensors themselves).  A first
        pass (no `end`: its device time runs to that event) copies its blob
        and vote need and leaves its tail on the device until a row needs
        it; a retry step copies its blob and tail, keeping no device
        tensor."""
        with Span("mapper.d2h", chunk):
            first = end is None
            blob = out["blob"].to("cpu", non_blocking=True)
            tail = out["ops_tail"] if first else \
                out["ops_tail"].to("cpu", non_blocking=True)
            need = out["vote_need"].to("cpu", non_blocking=True) if first \
                else None
            copied = self._event()
            return _Step(cfg, blob, tail, need, copied, start,
                         copied if first else end)

    def _read_back(self, step: _Step, *keys: str):
        """Wait for a step's copies and add its device time to each
        phase_s key of `keys`; return (meta, ops), the tail appended only
        where some row's runs reach the last eager slot (not the pad op; a
        head of no bytes has no tail, ops/step.pack_head)."""
        if step.copied is not None:
            step.copied.synchronize()
        if step.start is not None and step.end is not None:
            dt = step.start.elapsed_time(step.end) / 1e3
            for k in keys:
                self.phase_s[k] += dt
        mb, eb = 4 * step.cfg.meta_words, step.cfg.tb_entry_bytes
        blob = step.blob.numpy()
        meta, ops = np.ascontiguousarray(blob[:, :mb]).view(np.int32), \
            blob[:, mb:]
        if ops.shape[1] and (ops.shape[1] < eb
                             or (ops[:, -eb] & 3 != 3).any()):
            ops = np.concatenate([ops, step.tail.cpu().numpy()], axis=1)
        return meta, ops

    def _dispatch_chunk(self, prepared, chunk=None) -> List[_Part]:
        """Issue each part's step and queue its D2H copy: a _Part each."""
        L, prepped = prepared
        cfg = self._step_for(L)
        parts = []
        for part, codes, codes_rc, lens, limits in prepped:
            self._count(cfg, codes_rc)
            start, valid = self._event(), None
            if self.mesh is None:
                out = self._run_step(cfg, codes, codes_rc, lens, limits,
                                     chunk)
            else:
                from ..parallel.dist import sharded_map_step
                step = sharded_map_step(cfg, self.mesh)
                arrays = self._h2d(codes, codes_rc, lens, limits,
                                   chunk=chunk)
                with Span("mapper.step", chunk):
                    out, valid = step(self.idx, *arrays)
            parts.append(_Part(cfg, part, chunk,
                               self._start_d2h(cfg, out, start, chunk=chunk),
                               valid))
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

    def _fetch_chunk(self, parts: List[_Part]) -> List[_Part]:
        """The issue stage of a submitted chunk: for each part, read its
        first pass back, run the saturation tier, then issue the overflow
        tier's steps.  Nothing here waits for one: _finish_chunk does."""
        self._stage_seq += 1
        for p in parts:
            with Span("mapper.fetch", p.chunk, self.phase_s, "fetch"):
                p.meta, p.ops = self._read_back(p.first, "first_pass_device")
                p.eb = p.cfg.tb_entry_bytes
                if p.valid is not None:
                    self.valid_global += int(p.valid)
            p.need, p.first = p.first.need.numpy(), None
            self._retry_saturation(p)
            self._retry_overflow(p)
        return parts

    def _finish_chunk(self, parts: List[_Part]) -> List[_Part]:
        """The finish stage of an issued chunk: wait for each part's
        overflow steps and splice their rows in (_finish_overflow)."""
        for p in parts:
            self._finish_overflow(p)
        self._stage_seq += 1
        return parts

    def _count(self, cfg: MapperConfig, codes_rc) -> None:
        """Count a packed step of `cfg` in raw_chunks (`codes_rc` None: raw
        bytes) or host_chunks, and a gact step in gact_steps and, with
        int32 run entries, in int32_gact_steps."""
        if codes_rc is None:
            self.raw_chunks += 1
        else:
            self.host_chunks += 1
        if cfg.use_gact:
            self.gact_steps += 1
            self.int32_gact_steps += int(cfg.tb_entry_bytes == 4)

    def _issue_step(self, cfg: MapperConfig, part, chunk=None) -> _Step:
        """Run `cfg`'s step on the reads of `part` and queue its copies:
        its _Step.  Nothing waits here."""
        with Span("mapper.retry.pack", chunk, self.phase_s, "retry_pack"):
            packed = self._pack(part, cfg.L, cfg.B)
        self._count(cfg, packed[1])
        start = self._event()
        o = self._run_step(cfg, *packed, chunk=chunk)
        return self._start_d2h(cfg, o, start, self._event(), chunk)

    def _finish_step(self, step: _Step, chunk=None):
        """An issued retry step's (meta, ops) in full; its device time goes
        to retry_device, and to wide_vote_device for a class step."""
        with Span("mapper.retry.wait", chunk, self.phase_s, "retry_wait"):
            return self._read_back(step, "retry_device", *(
                ("wide_vote_device",) if step.wide else ()))

    def _retry_saturation(self, p: _Part) -> None:
        """Re-walk a gact part whose shared run buffer saturated (bit 1,
        ops/gact.gact_traceback_c) through the 4x-buffer tier, issued and
        waited for at once.  The flag is chunk-wide (the clamped last
        buffer row may hold any lane's runs), so the whole part re-runs; a
        flag that survives even 4x shows in overflow_reads.  Under a mesh a
        rank re-runs its own rows (JAX's mesh leaves the flag), with sharded
        tables together with its model group, whose ranks share the flag."""
        cfg = p.cfg
        if not cfg.use_gact or not (
                p.meta[:len(p.reads), cfg.meta_words - 1] & 2).any():
            return
        with Span("mapper.retry_saturation", p.chunk, self.phase_s, "retry"):
            sat = self._sat_step_for(cfg.L)
            p.meta, p.ops = self._finish_step(
                self._issue_step(sat, p.reads, p.chunk), p.chunk)
            p.eb = sat.tb_entry_bytes
        self.retried_sat_chunks += 1

    def _retry_overflow(self, p: _Part) -> None:
        """Issue into `retry` the exact-everything tier's steps for the
        reads flagged with vote overflow (bit 0) or a narrow-band ed (bit
        2), at most the tier's B a step.  The bit-0 reads whose widest vote
        row (`need`) passes the tier's slots take instead one wide vote
        class step a part, at the power-of-2 class of its widest need
        (vote_classes), its batch a power of 2 (_wide_batch bounds it).
        Bit 1 (gact saturation) is not retried here."""
        cfg = p.cfg
        if cfg.exact_slots:
            return
        flags = p.meta[:len(p.reads), cfg.meta_words - 1]
        flagged = np.flatnonzero(flags & 5)
        if flagged.size == 0:
            return
        with Span("mapper.retry_overflow", p.chunk, self.phase_s, "retry"):
            cfg_r = self._retry_step_for(cfg.L)
            slots = vote_classes(p.need[flagged], cfg_r.vote_slots)
            slots[(flags[flagged] & 1) == 0] = 0

            def issue(c, sel, wide=False):
                step = self._issue_step(c, [p.reads[i] for i in sel],
                                        p.chunk)
                step.sel, step.wide = sel, wide
                p.retry.append(step)

            exact = flagged[slots == 0]
            for s in range(0, exact.size, cfg_r.B):
                issue(cfg_r, exact[s:s + cfg_r.B])
            wide = flagged[slots > 0]
            if wide.size:
                with Span("mapper.retry.wide", p.chunk, self.phase_s,
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
        self.retry_steps += len(p.retry)
        p.issued_at = self._stage_seq

    def _widen(self, ops: np.ndarray, src: int, dst: int, chunk=None):
        """_widen_entries in a mapper.retry.widen span where it widens."""
        if src == dst:
            return ops
        with Span("mapper.retry.widen", chunk, self.phase_s, "widen"):
            return _widen_entries(ops, src, dst)

    def _finish_overflow(self, p: _Part) -> None:
        """Wait for a part's overflow steps and splice their rows in, the
        run entries of every row at the widest of the part's and the
        steps' widths (the narrower side widened, either way); a read a
        wide vote class step leaves with bit 0 counts in
        wide_vote_unresolved."""
        if not p.retry:
            return
        with Span("mapper.retry.finish", p.chunk, self.phase_s, "retry"):
            eb = max([p.eb] + [s.cfg.tb_entry_bytes for s in p.retry])
            meta = p.meta.copy()
            ops = (self._widen(p.ops, p.eb, eb, p.chunk) if eb != p.eb
                   else p.ops.copy())
            for step in p.retry:
                sel, c = step.sel, step.cfg
                meta_r, ops_r = self._finish_step(step, p.chunk)
                if step.wide:
                    self.wide_vote_unresolved += int(
                        (meta_r[:sel.size, c.meta_words - 1] & 1).sum())
                ops_r = self._widen(ops_r, c.tb_entry_bytes, eb, p.chunk)
                if ops_r.shape[1] > ops.shape[1]:
                    ops = np.pad(ops, ((0, 0), (0, ops_r.shape[1]
                                                - ops.shape[1])),
                                 constant_values=3)
                meta[sel] = meta_r[:sel.size]
                ops[sel] = 3          # blank any leftover compact-tier bytes
                ops[sel, :ops_r.shape[1]] = ops_r[:sel.size]
        if self._stage_seq > p.issued_at:
            self.deferred_retry_steps += len(p.retry)
        # the steps' pinned buffers go now, as the need does
        p.meta, p.ops, p.eb, p.need, p.retry = meta, ops, eb, None, []

    # ----------------------------------------------------------- assembly

    def _assemble(self, done: List[_Part], render) -> list:
        """render(part) of each part of a finished chunk; the reads whose
        final meta keeps a flag count in overflow_reads."""
        outs = []
        with Span("mapper.assemble", done[0].chunk, self.phase_s, "assemble"):
            for p in done:
                self.overflow_reads += int(
                    (p.meta[:len(p.reads), p.cfg.meta_words - 1] != 0).sum())
                outs.append(render(p))
        return outs

    def _records(self, done: List[_Part]) -> List[MapRecord]:
        return [r for recs in self._assemble(done, self._postprocess)
                for r in recs]

    def _sam(self, done: List[_Part]) -> Tuple[str, int, int]:
        outs = self._assemble(done, self._postprocess_sam)
        return ("".join(t for t, _ in outs), sum(len(p.reads) for p in done),
                sum(v for _, v in outs))

    def collect_chunk(self, pending) -> List[MapRecord]:
        """The MapRecords of a submitted chunk."""
        return self._records(self._finish_chunk(self._fetch_chunk(pending)))

    def map_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]
                  ) -> List[MapRecord]:
        """Map up to B reads: (name, seq, qual) tuples -> MapRecords."""
        return self.collect_chunk(self.submit_chunk(reads))

    def collect_chunk_sam(self, pending) -> Tuple[str, int, int]:
        """(sam_text, n_records, n_valid) for a submitted chunk."""
        return self._sam(self._finish_chunk(self._fetch_chunk(pending)))

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
        return self._stream(chunk_iter, self._records)

    def map_stream_sam(self, chunk_iter):
        """SAM text per chunk, (sam_text, n_records, n_valid)."""
        return self._stream(chunk_iter, self._sam)

    @contextmanager
    def _decoded(self, p: _Part):
        """A finished part's per-read lists, both outputs' input: found,
        valid (found, ED >= 0), strand, contig index, POS, ED, CIGAR (""
        without runs) and SEQ as written (reverse-complemented where found
        on the reverse strand), yielded in its mapper.assemble.records."""
        n = len(p.reads)
        m = p.meta[:n]
        if p.cfg.pos64:
            # [best_lo, best_hi, found, gi, strand, off_lo, off_hi, ed,
            #  limit, overflow]
            off = ((m[:, 6].astype(np.int64) << 32)
                   | m[:, 5].astype(np.uint32).astype(np.int64))
            found, gi, strand, ed = m[:, 2] != 0, m[:, 3], m[:, 4] != 0, \
                m[:, 7]
        else:
            found, gi, strand, off, ed = m[:, 1] != 0, m[:, 2], \
                m[:, 3] != 0, m[:, 4], m[:, 5]
        with Span("mapper.assemble.cigar", p.chunk, self.phase_s, "cigar"):
            cigs = self._cigars(p.ops[:n], p.eb)
        with Span("mapper.assemble.records", p.chunk):
            seqs = [s.encode().translate(_COMP)[::-1].decode() if r else s
                    for (_, s, _), r in zip(p.reads,
                                            (found & strand).tolist())]
            yield (found.tolist(), (found & (ed >= 0)).tolist(),
                   strand.tolist(), gi.tolist(), (off + 1).tolist(),
                   ed.tolist(), cigs, seqs)

    def _postprocess_sam(self, p: _Part) -> Tuple[str, int]:
        """A part's SAM text, one f-string a record, and its count of
        valid records."""
        names = self._names
        with self._decoded(p) as (found, valid, strand, gi, pos, ed, cigs,
                                  seqs):
            lines = []
            ap = lines.append
            for i, (name, _, qual) in enumerate(p.reads):
                q = qual if qual else "*"
                if valid[i]:
                    ap(f"{name}\t{16 if strand[i] else 0}\t{names[gi[i]]}\t"
                       f"{pos[i]}\t255\t{cigs[i] or '*'}\t*\t0\t0\t{seqs[i]}"
                       f"\t{q}\tED:I:{ed[i]}\n")
                elif found[i]:
                    ap(f"{name}\t4\t{names[gi[i]]}\t{pos[i]}\t0\t*\t*\t0"
                       f"\t0\t{seqs[i]}\t{q}\tED:I:-1\n")
                else:
                    ap(f"{name}\t4\t*\t1\t0\t*\t*\t0\t0\t{seqs[i]}\t{q}"
                       f"\tED:I:-1\n")
            return "".join(lines), sum(valid)

    def _postprocess(self, p: _Part) -> List[MapRecord]:
        """A part's MapRecords."""
        names = self._names
        with self._decoded(p) as (found, valid, strand, gi, pos, ed, cigs,
                                  seqs):
            return [MapRecord(
                qname=name, flag=(16 if strand[i] else 0) if valid[i] else 4,
                rname=names[gi[i]] if found[i] else "*",
                off=pos[i] - 1 if found[i] else 0,
                mapq=255 if valid[i] else 0,
                cigar=(cigs[i] or "*") if valid[i] else "*", seq=seqs[i],
                qual=qual if qual else "*", ed=ed[i] if found[i] else -1,
                valid=valid[i]) for i, (name, _, qual) in enumerate(p.reads)]
