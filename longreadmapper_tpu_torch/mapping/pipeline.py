"""The batched mapping step: seed -> vote -> locate -> align (port of the
short-read path of longreadmapper_tpu/mapping/pipeline.py).

Per read, as the reference's control flow and the JAX step:

  for each of seed_len+gap phase-shifted seed tilings:
      every informative seed (0 < hits < thres) votes diagonal SA - j;
      accept the phase's top-1 diagonal when (v1+v2)/num_seeds > 0.6,
      else its top-1 joins a cross-phase histogram
  locate: map the winning .cat offset to (contig, strand, offset)
  align:  banded NW against the same-length window, limit 2*err*len

Seeding is expand-and-verify: each hlen-mer lchash interval is expanded
directly and its `left = seed_len - hlen` prefix verified against the
fused (SA value, packed 16-base left context) row of `sa_ctx`; seeds whose
interval is >= thres wide are LF-narrowed on a compacted set of lanes.
All phases are one batched tensor step.

`map_step` returns the JAX step's two arrays byte for byte: `blob` (B,
4 * meta_words + head) int8 = the little-endian int32 meta words of each
read (8; 10 under pos64, whose positions ship as [lo, hi] pairs) followed
by the eager head of the pad-sorted CIGAR run entries, and `ops_tail`;
beside them `vote_need`, each read's widest vote row, which JAX does not
return: the mapper sizes a flagged read's exact vote by it.
`raw_map_step` is the JAX raw_step: it takes the ASCII of a chunk and
encodes and reverse-complements it on the device, each row at its own
read length (JAX's takes chunks of one length).

Index layouts (index/device.py): positions are int32, or int64 joined
from split-hi tables after each gather (pos64); the full layout gathers
each vote's verify window with its SA value, the slim one rebuilds it from
one text_pair gather (ops/seed_vote.py).

Align has two branches, chosen per length bucket by MapperConfig.use_gact:
  * resident dirs (L <= gact_threshold, or a direction volume within
    mid_dirs_budget): one banded DP pass emitting every direction word,
    then the column walk (int32 run entries once counts reach 8192);
  * tiled gact (longer buckets whose volume does not fit): a checkpointed
    forward pass, then the walk rematerializes the tiles' directions from
    their checkpoint rows, newest first, in groups of as many tiles as fit
    in mid_dirs_budget, one kernel launch a group (ops/gact.py); int32
    run entries where a count can pass 8191 (the full-band retry of reads
    past ~80 kb), where JAX raises.
Long buckets run a narrow first pass (short_W_override / half_band) and
flag reads whose ed reaches it (overflow bit 2) for the full-band retry.

The column traceback is the port's only walk.  On the card the seed vote
is two CUDA kernels (csrc/vote.cu through ops/seed_vote.py: the per-seed
tables; the pick, the vote rows and each read's accept in one launch) and
both walks are CUDA kernels (csrc/walk.cu: one launch a resident pass, one
a gact tile group), and the wide seeds are picked by a rank, not a branch,
so the step reads nothing back on the host.  The glue between them is
CUDA kernels too (csrc/step.cu through ops/step.py): the raw encode, the
locate with the read's strand and its target window, and the pack of the
meta words and the pad-sorted run entries; the walk's inputs from the
DP's centre column (G3, ops/step.lanes) have no launch of their own on
the card: the walk kernel, or the gact walk's setup launch, computes
each lane's from them (csrc/lanes.cuh) and writes those the pack reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import ClassVar

import numpy as np
import torch

from ..index.device import DeviceIndex, IndexMeta
from ..ops.band_dp import banded_nw_dirs
from ..ops.band_scores import band_checkpoints
from ..ops.gact import gact_group_tiles, gact_traceback_c
from ..ops.seed_vote import seed_tables, vote_need, vote_rows, wide_rank
from ..ops.step import encode_raw, lanes, locate_window, pack
from ..ops.traceback import device_traceback_c
from ..ops.vote import pow2_at_least
from ..utils.config import Params

I32 = torch.int32


@dataclass(frozen=True)
class MapperConfig:
    """Static shape parameters of one step (the JAX MapperConfig's fields
    that the ported paths read, with JAX's defaults; it reads no
    environment knobs)."""
    B: int               # reads per device chunk
    L: int               # padded max read length (a bucket)
    seed_len: int
    gap_len: int
    thres: int
    hlen: int
    n: int               # .cat length
    dollar_pos: int
    accept_score: float
    error_rate: float
    vote_budget: int = 256
    wide_budget: int = 0
    exact_slots: bool = False   # full headroom budget (the retry tier)
    gact_tile: int = 512        # row tile of the checkpointed long-read path
    gact_threshold: int = 2048  # longer buckets may take the gact path
    gact_runs_scale: int = 1    # gact run-buffer multiplier (saturation tier)
    # direction-volume ceiling of the resident path for long buckets: above
    # it a long bucket takes the tiled gact path
    mid_dirs_budget: int = 1 << 30
    half_band: bool = False     # gact first pass at W/2 (overflow bit 2)
    short_W_override: int = 0   # resident first pass at this W (bit 2)
    pos64: bool = False         # int64 positions from split-hi tables
    slim: bool = False          # slim index layout (text_pair windows)
    # a long bucket takes the tiled gact path whatever its direction
    # volume: a wide vote class step runs its retry tier's path
    tiled: bool = False
    OPS_HEAD_COLS: ClassVar[int] = 16      # eager CIGAR run bytes per read

    @property
    def phases(self) -> int:
        return self.seed_len + self.gap_len

    @property
    def step(self) -> int:
        return self.seed_len + self.gap_len

    @property
    def left(self) -> int:
        assert 0 <= self.seed_len - self.hlen <= 16, \
            "expand-and-verify supports hlen <= seed_len <= hlen + 16"
        return self.seed_len - self.hlen

    @property
    def max_seeds(self) -> int:
        if self.L <= self.seed_len:
            return 1
        return max(1, -(-(self.L - self.seed_len) // self.step))

    @property
    def npos(self) -> int:
        return self.max_seeds * self.phases

    @property
    def wide_lanes(self) -> int:
        if self.wide_budget > 0:
            return self.wide_budget
        return max(512, (self.B * self.phases * self.max_seeds) // 16)

    @property
    def accept_frac(self):
        """accept_score as an exact small rational (num, den)."""
        f = Fraction(self.accept_score).limit_denominator(10000)
        return f.numerator, f.denominator

    @property
    def vote_slots_exact(self) -> int:
        """Full-headroom slots per (read, phase): max_seeds self-hits plus
        2x the background lam = n/4^hlen, rounded up to 128."""
        lam = self.n / float(4 ** self.hlen)
        need = int(self.max_seeds * (1 + 2 * max(lam, 0.5))) + 64
        want = max(self.vote_budget, need, 128)
        return -(-want // 128) * 128

    @property
    def vote_slots_max(self) -> int:
        """The widest row the exact tier may vote: every seed of a phase
        at thres - 1 occurrences (the most an informative seed has),
        padded to a power of 2, the vote kernels' sort width."""
        return pow2_at_least(self.max_seeds * (self.thres - 1))

    @property
    def vote_slots(self) -> int:
        """Compact-tier slots: mean + 5 sigma of the background, 16-granular;
        overflowing reads re-run through the exact tier."""
        if self.exact_slots:
            return self.vote_slots_exact
        lam = self.n / float(4 ** self.hlen)
        mean = self.max_seeds * (1 + max(lam, 0.05))
        sigma = (self.max_seeds * max(lam, 0.05)) ** 0.5
        want = int(mean + 5.0 * sigma) + 16
        return min(self.vote_slots_exact, max(64, -(-want // 16) * 16))

    @property
    def W(self) -> int:
        # static band half-width >= every read's limit (len <= L)
        return max(8, int(self.error_rate * self.L * 2))

    @property
    def use_gact(self) -> bool:
        """Long buckets whose resident direction volume passes the budget
        take the tiled gact path."""
        if self.L <= self.gact_threshold:
            return False
        if self.tiled:
            return True
        vol = self.B * (self.L // 16) * self.short_band * 4
        return vol > self.mid_dirs_budget

    @property
    def gact_W(self) -> int:
        # half-band first pass: a lane with ed < W' has the same H values
        # (and walk) in the W' band as in the full one; ed' >= W' lanes
        # flag bit 2 for the full-band retry
        if self.half_band:
            return min(self.W, max(64, self.W // 2))
        return self.W

    @property
    def gact_band(self) -> int:
        return -(-(2 * self.gact_W + 1) // 128) * 128

    @property
    def short_W(self) -> int:
        if 0 < self.short_W_override < self.W:
            return self.short_W_override
        return self.W

    @property
    def short_band(self) -> int:
        return -(-(2 * self.short_W + 1) // 128) * 128

    @property
    def tb_entry_bytes(self) -> int:
        """Width of the column walk's run entries: the count field is
        entry_bits - 2 wide, so int16 holds counts to 8191, then int32.
        Resident counts reach max(L, band - W); the gact walk's max(T,
        band - W) (an M-run stops at its tile's floor): int16 for every
        gact pass up to the 50 kb bucket's retry, int32 for the full-band
        retry of reads past ~80 kb (JAX refuses those, ROADMAP.md C)."""
        if self.use_gact:
            cmax = max(self.gact_tile, self.gact_band - self.gact_W)
        else:
            cmax = max(self.L, self.short_band - self.short_W)
        return 2 if cmax < 8192 else 4

    @property
    def entry_dtype(self) -> torch.dtype:
        """The run entries' dtype, tb_entry_bytes wide."""
        return torch.int16 if self.tb_entry_bytes == 2 else torch.int32

    @property
    def meta_words(self) -> int:
        """int32 words per read in `blob`: positions (best, off) ship as
        [lo, hi] pairs under pos64."""
        return 10 if self.pos64 else 8

    @staticmethod
    def from_params(p: Params, meta: IndexMeta, B: int, L: int
                    ) -> "MapperConfig":
        return MapperConfig(
            B=B, L=L, seed_len=p.seed_len, gap_len=p.gap_len,
            thres=p.thres, hlen=meta.hlen, n=meta.n,
            dollar_pos=meta.dollar_pos, accept_score=p.accept_score,
            error_rate=p.error_rate, vote_budget=p.vote_budget,
            pos64=meta.pos_dtype == "int64", slim=meta.slim)


def _seed_vote(cfg: MapperConfig, idx: DeviceIndex, codes, lens,
               mark=None):
    """All seeding phases in one batched pass; returns (best, overflow).
    `mark(stage)`, when given, follows seed_tables, narrow (the wide
    seeds' rank), vote_rows (the pick, the vote and each read's accept, one
    launch on CUDA) and accept (nothing left to issue: JAX's accept ran in
    the vote's launch)."""
    return _seed_vote_need(cfg, idx, codes, lens, mark)[:2]


def _seed_vote_need(cfg: MapperConfig, idx: DeviceIndex, codes, lens,
                    mark=None):
    """_seed_vote's (best, overflow) and each read's widest row as the
    exact tier votes it (vote_need), issued before mark("vote_rows")."""
    mark = mark or (lambda stage: None)
    tabs = seed_tables(cfg, idx, codes, lens)
    mark("seed_tables")
    rank = wide_rank(tabs[3])
    mark("narrow")
    best, overflow, _ = vote_rows(cfg, idx, lens, tabs, rank)
    need = vote_need(cfg, tabs)
    mark("vote_rows")
    mark("accept")
    return best, overflow, need


def vote_classes(need, exact: int) -> np.ndarray:
    """The slots a read's wide vote class step gives each of its rows: 0
    where `need` (vote_need's, each read's widest row) fits the exact
    tier's `exact` slots, else the least power of 2 that holds it."""
    return np.array([pow2_at_least(int(x)) if x > exact else 0
                     for x in np.asarray(need).ravel()], dtype=np.int64)


def map_step(cfg: MapperConfig, idx: DeviceIndex, codes, codes_rc, lens,
             limits, mark=None):
    """One device step.  codes/codes_rc (B, L) int8 (the reverse
    complement front-aligned, pad 4), lens/limits (B,) int32 on the index's
    device.  Returns dict(blob (B, 32 + head) int8, ops_tail (B, K - head)
    int8), byte-identical to the JAX make_map_step, and vote_need (B,)
    int32, each read's widest vote row (ops/seed_vote.vote_need), which
    sizes the mapper's wide vote classes.  `mark(stage)`, when
    given, is called as each stage has been issued (runtime/stages.py
    times them): seed_tables, narrow, vote_rows and accept (the seed
    vote, _seed_vote), locate_window, then band_dp + walk on the
    resident path or gact_forward + gact_walk on the gact path, then
    pack."""
    mark = mark or (lambda stage: None)
    lens = lens.to(I32)
    limit = limits.to(I32)
    best, overflow, need = _seed_vote_need(cfg, idx, codes, lens, mark)

    # the contig, strand and offset of each read's best diagonal; the read
    # on that strand (q: reverse-strand reads align their reverse
    # complement) and its target window (t)
    found, gi, strand, off, _, _, q, t = locate_window(cfg, idx, best, lens,
                                                       codes, codes_rc)
    mark("locate_window")

    if cfg.use_gact:
        # long reads: checkpointed forward pass + rematerialized walk keep
        # memory O(L/T * band) instead of O(L * band) (ops/gact.py)
        T, Wp = cfg.gact_tile, cfg.gact_W
        ckpt, wcol = band_checkpoints(q, t, T, Wp, cfg.gact_band)
        mark("gact_forward")
        narrow = cfg.half_band
    else:
        Wp = cfg.short_W
        vdirs, wcol, nm = banded_nw_dirs(q, t, Wp, cfg.short_band)
        mark("band_dp")
        narrow = Wp < cfg.W
    # ed', the narrow pass's band-short lanes (overflow bit 2) and the
    # lanes that walk (dead lanes, unmapped or over the limit, do not): on
    # the card no launch of their own, the walk's launch computes them
    ln = lanes(wcol, lens, limit, found, overflow, Wp, narrow)
    if cfg.use_gact:
        # tiles are rematerialized in groups that fit the direction budget
        run_units, saturated = gact_traceback_c(
            q, t, ckpt, ln, T, Wp, cfg.gact_band,
            scale=cfg.gact_runs_scale,
            group=gact_group_tiles(cfg.B, cfg.L, T, cfg.gact_band,
                                   cfg.mid_dirs_budget),
            entry_dtype=cfg.entry_dtype)
        mark("gact_walk")
    else:
        run_units = device_traceback_c(vdirs, ln, cfg.L, Wp, nm,
                                       entry_dtype=cfg.entry_dtype)
        saturated = None
        mark("walk")
    # the meta words, then the run entries pad-sorted (path order kept)
    # as little-endian bytes: the eager head in the blob, the rest in the
    # tail; a saturated gact run buffer sets overflow bit 1
    out = pack(cfg, best, found, gi, strand, off, ln, limit, run_units,
               saturated)
    mark("pack")
    out["vote_need"] = need
    return out


def raw_map_step(cfg: MapperConfig, idx: DeviceIndex, raw, lens, limits,
                 mark=None):
    """map_step of a chunk shipped as raw ASCII (B, L) uint8 on the index's
    device, row i a read lens[i] long and zero past it, ragged or not: the
    JAX raw_step, which takes one length, at each row's own.  Half the H2D
    bytes of the host encode's two int8 arrays; byte-identical output.
    `mark("encode")` follows the encode."""
    codes, codes_rc = encode_raw(raw, lens)
    if mark is not None:
        mark("encode")
    return map_step(cfg, idx, codes, codes_rc, lens, limits, mark)
