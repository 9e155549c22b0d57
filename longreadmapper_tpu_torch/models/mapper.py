"""TorchMapper — the end-to-end mapping model of the port (counterpart of
longreadmapper_tpu/models/mapper.py::TPUMapper).

Bundles the device-resident DeviceIndex with the mapping step (one config
per read-length bucket) and the host post-processing (CIGAR decode + SAM).
A chunk part whose reads all have one length ships as raw ASCII and is
encoded on the device (pipeline.raw_map_step, the JAX mapper's raw
variant); ragged parts and every retry tier are encoded on the host.
`map_stream` yields each chunk's MapRecords, `map_stream_sam` its SAM
text, both through one depth-3 submit/collect queue.

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

import time
from collections import deque
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import pick_device
from ..formats.fastx import _encode_lut
from ..formats.sam import cigar_string, sam_record
from ..index.device import DeviceIndex, IndexMeta
from ..mapping.pipeline import MapperConfig, map_step, raw_map_step
from .. import native_build
from ..utils.config import Params


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


_OP_CHARS = np.frombuffer(b"MID?", dtype=np.uint8)
_COMP_STR = str.maketrans("ACGTacgt", "TGCATGCA")


def revcomp(s: str) -> str:
    """Reverse complement, lowercase to UPPER complement (the oracle's)."""
    return s.translate(_COMP_STR)[::-1]


def _rle_groups(runs: np.ndarray, entry_bytes: int = 1):
    """Decode a whole chunk's run entries ((count << 2) | op in reverse
    path order; 2/4-byte entries arrive as little-endian byte groups) into
    merged forward-order groups (g_row, g_op, tot)."""
    if entry_bytes > 1:
        w = runs.shape[1] - runs.shape[1] % entry_bytes
        runs = np.ascontiguousarray(runs[:, :w]).view(
            np.int16 if entry_bytes == 2 else np.int32)
    rev = runs[:, ::-1]
    op = rev & 3
    cnt = (rev >> 2).astype(np.int64)
    valid = (op != 3) & (cnt > 0)
    rows, cols = np.nonzero(valid)
    if rows.size == 0:
        return rows, rows, rows
    ops_f = op[rows, cols]
    cnt_f = cnt[rows, cols]
    brk = np.empty(rows.size, dtype=bool)
    brk[0] = True
    brk[1:] = (rows[1:] != rows[:-1]) | (ops_f[1:] != ops_f[:-1])
    starts = np.flatnonzero(brk)
    return rows[starts], ops_f[starts], np.add.reduceat(cnt_f, starts)


def _rle_runs_batch(runs: np.ndarray,
                    entry_bytes: int = 1) -> List[List[Tuple[int, str]]]:
    out: List[List[Tuple[int, str]]] = [[] for _ in range(runs.shape[0])]
    for r, o, t in zip(*_rle_groups(runs, entry_bytes)):
        out[r].append((int(t), chr(_OP_CHARS[o])))
    return out


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


def _cigar_strings_batch(runs: np.ndarray,
                         entry_bytes: int = 1) -> List[str]:
    g_row, g_op, tot = _rle_groups(runs, entry_bytes)
    parts: List[List[str]] = [[] for _ in range(runs.shape[0])]
    opc = "MID?"
    for r, o, t in zip(g_row.tolist(), g_op.tolist(), tot.tolist()):
        parts[r].append(f"{t}{opc[o]}")
    return ["".join(p) for p in parts]


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
        self.overflow_reads = 0   # reads whose final meta carries a flag
        self.retried_reads = 0    # reads re-run through the exact tier
        self.retried_sat_chunks = 0   # gact chunks re-walked, 4x run buffer
        self.raw_chunks = 0       # chunk parts encoded on the device
        self.host_chunks = 0      # chunk parts encoded on the host (ragged)
        # mapped reads of all ranks, from the mesh's collective counter
        self.valid_global = 0
        # wall-clock seconds per host phase: prepare = read packing,
        # dispatch = H2D + step (enqueued; the step waits on the device only
        # at the seed vote's wide-seed test), fetch = waiting for the D2H
        # copies, assemble = SAM building
        self.phase_s = {"prepare": 0.0, "dispatch": 0.0, "fetch": 0.0,
                        "assemble": 0.0}

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
        host-encoded, raw (single device) and the exact-everything retry
        (where the first pass is compact or narrow).  Each runs on a part
        of pad rows, which loads its kernels' modules and fills the
        allocator's pools; no counter of the mapper moves.  Returns the
        elapsed seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            native_build.build(names=("band_dp", "band_scores", "walk"))
        for L in sorted({_bucket_len(int(n)) for n in lengths}):
            cfg = self._step_for(L)
            variants = [(cfg, False)]
            if self.mesh is None:
                variants.append((cfg, True))
                if not cfg.exact_slots and (
                        cfg.vote_slots < cfg.vote_slots_exact
                        or cfg.half_band):
                    variants.append((self._retry_step_for(L), False))
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

    def _h2d(self, *arrays):
        """numpy -> device tensors; through pinned memory with
        non-blocking copies on the current stream when on CUDA."""
        if self.device.type == "cpu":
            return [torch.from_numpy(a) for a in arrays]
        return [torch.from_numpy(a).pin_memory().to(self.device,
                                                    non_blocking=True)
                for a in arrays]

    def _run_step(self, cfg: MapperConfig, codes, codes_rc, lens, limits):
        """The step of one packed part; `codes_rc` None marks raw bytes
        (_pack_raw), whose read length is known here on the host.  Runs
        map_step on the mapper's index: under a sharded mesh every rank
        of the model group must make the same calls."""
        if codes_rc is None:
            draw, dl, dlim = self._h2d(codes, lens, limits)
            return raw_map_step(cfg, self.idx, draw, dl, dlim,
                                int(lens.max()))
        dc, drc, dl, dlim = self._h2d(codes, codes_rc, lens, limits)
        return map_step(cfg, self.idx, dc, drc, dl, dlim)

    def _start_d2h(self, out: dict) -> dict:
        """Queue the blob's D2H copy into pinned memory on the current
        CUDA stream (non-blocking) and record an event to wait on; the
        CIGAR tail stays on the device until a read needs it."""
        if self.device.type == "cpu":
            return dict(blob=out["blob"], ops_tail=out["ops_tail"],
                        event=None)
        blob_h = torch.empty(out["blob"].shape, dtype=out["blob"].dtype,
                             pin_memory=True)
        blob_h.copy_(out["blob"], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return dict(blob=blob_h, ops_tail=out["ops_tail"], event=ev)

    @staticmethod
    def _split_blob(cfg: MapperConfig, blob: np.ndarray):
        mb = 4 * cfg.meta_words
        return np.ascontiguousarray(blob[:, :mb]).view(np.int32), blob[:, mb:]

    def _dispatch_chunk(self, prepared):
        L, prepped = prepared
        cfg = self._step_for(L)
        parts = []
        for part, codes, codes_rc, lens, limits in prepped:
            if codes_rc is None:
                self.raw_chunks += 1
            else:
                self.host_chunks += 1
            if self.mesh is None:
                out = self._run_step(cfg, codes, codes_rc, lens, limits)
                valid = None
            else:
                from ..parallel.dist import sharded_map_step
                out, valid = sharded_map_step(cfg, self.mesh)(
                    self.idx, *self._h2d(codes, codes_rc, lens, limits))
            parts.append((cfg, part, lens,
                          dict(self._start_d2h(out), valid=valid)))
        return parts

    def submit_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]):
        """Pack and run the device step for up to B reads."""
        t0 = time.perf_counter()
        prepared = self._prepare_chunk(reads)
        t1 = time.perf_counter()
        out = self._dispatch_chunk(prepared)
        self.phase_s["prepare"] += t1 - t0
        self.phase_s["dispatch"] += time.perf_counter() - t1
        return out

    def _fetch_chunk(self, pending):
        """Wait for each part's D2H copy; fetch the CIGAR tail only when
        some read's runs reach the end of the eager head."""
        fetched = []
        for cfg, reads, lens, out in pending:
            if out["event"] is not None:
                out["event"].synchronize()
            if out["valid"] is not None:
                self.valid_global += int(out["valid"])
            meta, ops = self._split_blob(cfg, out["blob"].numpy())
            if _tail_needed(ops, cfg.tb_entry_bytes):
                ops = np.concatenate(
                    [ops, out["ops_tail"].cpu().numpy()], axis=1)
            res = self._retry_saturation(cfg, reads, dict(meta=meta, ops=ops))
            res = self._retry_overflow(cfg, reads, res)
            fetched.append((cfg, reads, lens, res))
        return fetched

    def _fetch_step(self, cfg: MapperConfig, part):
        """Run `cfg`'s step on the reads of `part` and fetch its (meta,
        ops) in full."""
        o = self._run_step(cfg, *self._pack_reads(part, cfg.L, cfg.B))
        meta, ops = self._split_blob(cfg, o["blob"].cpu().numpy())
        if ops.shape[1] and _tail_needed(ops, cfg.tb_entry_bytes):
            ops = np.concatenate([ops, o["ops_tail"].cpu().numpy()], axis=1)
        return meta, ops

    def _retry_saturation(self, cfg: MapperConfig, reads, out):
        """Re-walk a gact chunk whose shared run buffer saturated (bit 1,
        ops/gact.gact_traceback_c) through the 4x-buffer tier.  The flag is
        chunk-wide (the clamped last buffer row may hold any lane's runs),
        so the whole chunk re-runs and its meta/ops are replaced; a flag
        that survives even 4x shows in overflow_reads.  Under a mesh a rank
        re-runs its own rows (JAX's mesh mode leaves the flag unrecovered):
        with a replicated index alone, with sharded tables together with
        its model group, whose ranks hold the same rows and so the same
        flag."""
        if not cfg.use_gact or not (
                out["meta"][:len(reads), cfg.meta_words - 1] & 2).any():
            return out
        meta, ops = self._fetch_step(self._sat_step_for(cfg.L), reads)
        self.retried_sat_chunks += 1
        return dict(out, meta=meta, ops=ops)

    def _retry_overflow(self, cfg: MapperConfig, reads, out):
        """Re-map reads flagged with vote overflow (bit 0) or a narrow-band
        ed (bit 2) through the exact-everything tier and splice their rows
        (meta with the real flag, run bytes) in, their run entries widened
        to the chunk's width, which the assembly decodes with.  Bit 1
        (gact saturation) is not retried here: more vote slots cannot fix
        it."""
        if cfg.exact_slots:
            return out
        meta = out["meta"]
        flagged = np.flatnonzero(meta[:len(reads), cfg.meta_words - 1] & 5)
        if flagged.size == 0:
            return out
        cfg_r = self._retry_step_for(cfg.L)
        meta = meta.copy()
        ops = np.asarray(out["ops"]).copy()
        for s in range(0, flagged.size, cfg_r.B):
            sel = flagged[s:s + cfg_r.B]
            meta_r, ops_r = self._fetch_step(cfg_r, [reads[i] for i in sel])
            ops_r = _widen_entries(ops_r, cfg_r.tb_entry_bytes,
                                   cfg.tb_entry_bytes)
            if ops_r.shape[1] > ops.shape[1]:
                pad = np.full((ops.shape[0], ops_r.shape[1] - ops.shape[1]),
                              3, np.int8)
                ops = np.concatenate([ops, pad], axis=1)
            meta[sel] = meta_r[:sel.size]
            ops[sel] = 3          # blank any leftover compact-tier bytes
            ops[sel, :ops_r.shape[1]] = ops_r[:sel.size]
        self.retried_reads += int(flagged.size)
        return dict(out, meta=meta, ops=ops)

    # ----------------------------------------------------------- assembly

    def _count_overflow(self, cfg, reads, out) -> None:
        self.overflow_reads += int(
            (out["meta"][:len(reads), cfg.meta_words - 1] != 0).sum())

    def collect_chunk(self, pending) -> List[MapRecord]:
        t0 = time.perf_counter()
        fetched = self._fetch_chunk(pending)
        t1 = time.perf_counter()
        recs: List[MapRecord] = []
        for cfg, reads, lens, out in fetched:
            self._count_overflow(cfg, reads, out)
            recs.extend(self._postprocess(cfg, reads, lens, out))
        self.phase_s["fetch"] += t1 - t0
        self.phase_s["assemble"] += time.perf_counter() - t1
        return recs

    def map_chunk(self, reads: Sequence[Tuple[str, str, Optional[str]]]
                  ) -> List[MapRecord]:
        """Map up to B reads: (name, seq, qual) tuples -> MapRecords."""
        return self.collect_chunk(self.submit_chunk(reads))

    def collect_chunk_sam(self, pending) -> Tuple[str, int, int]:
        """(sam_text, n_records, n_valid) for a submitted chunk."""
        t0 = time.perf_counter()
        fetched = self._fetch_chunk(pending)
        t1 = time.perf_counter()
        text, total, valid = [], 0, 0
        for cfg, reads, lens, out in fetched:
            self._count_overflow(cfg, reads, out)
            t, v = self._postprocess_sam(cfg, reads, lens, out)
            text.append(t)
            total += len(reads)
            valid += v
        self.phase_s["fetch"] += t1 - t0
        self.phase_s["assemble"] += time.perf_counter() - t1
        return "".join(text), total, valid

    def _stream(self, chunk_iter, collect):
        """collect(pending) per chunk, in order, with a depth-3
        submit/collect queue: each chunk's D2H copy, queued by
        submit_chunk, lands while the next chunks' steps run."""
        queue = deque()
        for chunk in chunk_iter:
            queue.append(self.submit_chunk(chunk))
            if len(queue) > 2:
                yield collect(queue.popleft())
        while queue:
            yield collect(queue.popleft())

    def map_stream(self, chunk_iter):
        """List[MapRecord] per chunk of an iterator of read chunks."""
        return self._stream(chunk_iter, self.collect_chunk)

    def map_stream_sam(self, chunk_iter):
        """SAM text per chunk, (sam_text, n_records, n_valid)."""
        return self._stream(chunk_iter, self.collect_chunk_sam)

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

    def _postprocess_sam(self, cfg: MapperConfig, reads, lens, out
                         ) -> Tuple[str, int]:
        """Chunk-vectorized SAM assembly, one f-string per record."""
        found, gi, strand, off, ed = self._meta_cols(cfg, out["meta"])
        n = len(reads)
        cigs = _cigar_strings_batch(np.asarray(out["ops"][:n]),
                                    cfg.tb_entry_bytes)
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
                ap(f"{name}\t4\t{names[gi_l[i]]}\t{pos_l[i]}\t0\t*\t*\t0\t0"
                   f"\t{seq}\t{q}\tED:I:-1\n")
            else:
                ap(f"{name}\t4\t*\t1\t0\t*\t*\t0\t0\t{seq}\t{q}\tED:I:-1\n")
        return "".join(lines), n_valid

    def _postprocess(self, cfg: MapperConfig, reads, lens, out
                     ) -> List[MapRecord]:
        found, gi, strand, off, ed = self._meta_cols(cfg, out["meta"])
        all_runs = _rle_runs_batch(np.asarray(out["ops"]),
                                   cfg.tb_entry_bytes)
        recs: List[MapRecord] = []
        for i, (name, seq, qual) in enumerate(reads):
            ok = bool(found[i])
            ed_i = int(ed[i]) if ok else -1
            valid = ok and ed_i >= 0
            if valid:
                ops = all_runs[i]
                cig = cigar_string(ops) if ops else "*"
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
