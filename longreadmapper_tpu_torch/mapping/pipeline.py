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
by the eager head of the pad-sorted CIGAR run entries, and `ops_tail`.
`raw_map_step` is the JAX raw_step: it takes the ASCII of a uniform chunk
and encodes and reverse-complements it on the device.

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
    in mid_dirs_budget, one kernel launch a group (ops/gact.py).
Long buckets run a narrow first pass (short_W_override / half_band) and
flag reads whose ed reaches it (overflow bit 2) for the full-band retry.

The column traceback is the port's only walk.  On the card the seed vote
is two CUDA kernels (csrc/vote.cu through ops/seed_vote.py: the per-seed
tables, a CTA a vote row) and both walks are CUDA kernels (csrc/walk.cu:
one launch a resident pass, one a gact tile group), and the wide seeds are
picked by a rank, not a branch, so the step reads nothing back on the
host.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import ClassVar

import torch

from ..index.device import DeviceIndex, IndexMeta
from ..ops.band_dp import banded_nw_dirs
from ..ops.band_scores import band_checkpoints
from ..ops.gact import gact_group_tiles, gact_traceback_c
from ..ops.seed_vote import seed_tables, vote_rows
from ..ops.traceback import device_traceback_c
from ..ops.vote import top2_small_histo
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
        entry_bits - 2 wide.  Resident counts reach max(L, band - W), so
        int16 until 8192, then int32; the gact walk's counts are bounded
        by max(T, band - W) < 8192 (checked in ops/gact), so int16."""
        if self.use_gact:
            return 2
        cmax = max(self.L, self.short_band - self.short_W)
        return 2 if cmax < 8192 else 4

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


def _pick_wide_seeds(cfg: MapperConfig, wide, k12, cnt12, kw, cw):
    """The narrowed wide seeds JAX keeps: its _narrow_wide_seeds compacts
    the first cfg.wide_lanes wide seeds of the chunk in flat order onto
    its lanes (a stable sort), LF-narrows them and scatters them back; the
    rest vote nothing and flag their row.  seed_tables has narrowed every
    wide seed already (kw, cw), so picking is a rank: a wide seed is kept
    when at most wide_lanes wide seeds come before it and itself.  No
    branch and no host sync: with no wide seed it returns (k12, cnt12,
    no overflow), JAX's lax.cond's other branch.

    Returns (k_seed, cnt, row_overflow)."""
    flat = wide.reshape(-1)
    rank = torch.cumsum(flat, 0, dtype=I32)
    picked = (flat & (rank <= min(cfg.wide_lanes, flat.shape[0]))
              ).reshape(wide.shape)
    k_seed = torch.where(picked, kw, k12)
    cnt = torch.where(wide, torch.where(picked, cw, 0), cnt12)
    return k_seed, cnt, (wide & ~picked).any(dim=1)


def _seed_vote(cfg: MapperConfig, idx: DeviceIndex, codes, lens,
               mark=None):
    """All seeding phases in one batched pass; returns (best, overflow).
    `mark(stage)`, when given, follows seed_tables, narrow, vote_rows and
    accept."""
    mark = mark or (lambda stage: None)
    B, P = cfg.B, cfg.phases
    dev = codes.device
    qw, k12, cnt12, wide, kw, cw = seed_tables(cfg, idx, codes, lens)
    mark("seed_tables")
    k_seed, cnt, wide_overflow = _pick_wide_seeds(cfg, wide, k12, cnt12,
                                                  kw, cw)
    mark("narrow")
    CS = cfg.vote_slots
    v1, key1, v2, total = vote_rows(cfg, idx, k_seed, cnt, qw, wide)
    mark("vote_rows")
    v1 = v1.reshape(B, P)
    key1 = key1.reshape(B, P)
    v2 = v2.reshape(B, P)

    # per-phase accept, (v1+v2)/num_seeds > accept_score as exact rational
    num_seeds = (lens.to(I32) // cfg.step)[:, None]
    nacc, dacc = cfg.accept_frac
    accept = (num_seeds > 0) & ((v1 + v2) * dacc > nacc * num_seeds)
    any_acc = accept.any(dim=1)
    it_star = accept.to(I32).argmax(dim=1)              # first accepted
    best_acc = key1.gather(1, it_star[:, None])[:, 0]

    # outer histogram: every phase before the accepted one (all if none)
    pidx = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    upto = torch.where(any_acc, it_star, P)[:, None]
    outer_valid = (num_seeds > 0) & (v1 != 0) & (pidx < upto)
    _, okey1, _ = top2_small_histo(key1, outer_valid)

    # no acceptance, or acceptance on the last phase: outer top-1 wins
    need_outer = ~any_acc | (it_star == P - 1)
    best = torch.where(need_outer, okey1, best_acc)
    executed = pidx <= torch.where(any_acc, it_star, P - 1)[:, None]
    per_phase_ovf = ((total > CS) | wide_overflow).reshape(B, P)
    overflow = (per_phase_ovf & executed).any(dim=1)
    mark("accept")
    return best, overflow


def _seq_lookup(idx: DeviceIndex, loc, qlen):
    """First contig whose forward or reverse half fully contains
    [loc, loc+qlen), in the contig table's position dtype (int64 under
    pos64).  Returns (found, gi, strand, off, loc_fwd)."""
    pdt = idx.mta_start.dtype
    start = idx.mta_start[None, :]
    slen = idx.mta_len[None, :]
    end = start + 2 * slen
    loc_ = loc.to(pdt)[:, None]
    q_ = qlen.to(pdt)[:, None]
    fwd = (loc_ >= start) & (loc_ + q_ <= start + slen)
    rev = (loc_ >= start + slen) & (loc_ + q_ <= end)
    hit = fwd | rev
    found = hit.any(dim=1)
    gi = hit.to(I32).argmax(dim=1)
    g_start = idx.mta_start[gi]
    g_end = g_start + 2 * idx.mta_len[gi]
    strand = rev.gather(1, gi[:, None])[:, 0] & found
    off = torch.where(strand, g_end - loc.to(pdt) - qlen.to(pdt),
                      loc.to(pdt) - g_start)
    loc_fwd = torch.where(strand, off + g_start, loc.to(pdt))
    return found, gi.to(I32), strand, off, loc_fwd


def _target_windows(cfg: MapperConfig, idx: DeviceIndex, safe_loc):
    """(B, L) int8 target codes at [safe_loc, safe_loc + L) from the 2-bit
    packed text: L/16 + 1 words per read realigned by the sub-word offset;
    '$' (position n-1) and out-of-range positions become 5."""
    B, L = cfg.B, cfg.L
    nwords = L // 16
    dev = safe_loc.device
    tp = idx.text_packed
    w0 = (safe_loc >> 4).to(torch.int64)
    o = (safe_loc & 15).to(torch.int64)[:, None]
    # JAX reads zero pad words past the end; those positions are >= n and
    # masked to 5 below, so a clamped index reads an equivalent word
    widx = (w0[:, None] + torch.arange(nwords + 1, device=dev)[None, :]
            ).clamp(0, tp.shape[0] - 1)
    words = tp[widx].to(torch.int64) & 0xFFFFFFFF
    lo = words[:, :-1] >> (2 * o)
    hi = (words[:, 1:] << (32 - 2 * o)) & 0xFFFFFFFF     # 0 when o == 0
    aligned = lo | hi                                    # (B, nwords)
    shifts = 2 * torch.arange(16, device=dev)
    t = ((aligned[:, :, None] >> shifts) & 3).reshape(B, L)
    gpos = safe_loc[:, None].to(torch.int64) + torch.arange(L, device=dev)
    return torch.where(gpos >= cfg.n - 1, 5, t).to(torch.int8)


def map_step(cfg: MapperConfig, idx: DeviceIndex, codes, codes_rc, lens,
             limits, mark=None):
    """One device step.  codes/codes_rc (B, L) int8 (the reverse
    complement front-aligned, pad 4), lens/limits (B,) int32 on the index's
    device.  Returns dict(blob (B, 32 + head) int8, ops_tail (B, K - head)
    int8), byte-identical to the JAX make_map_step.  `mark(stage)`, when
    given, is called as each stage has been issued (runtime/stages.py
    times them): seed_tables, narrow, vote_rows and accept (the seed
    vote, _seed_vote), locate_window, then band_dp + walk on the
    resident path or gact_forward + gact_walk on the gact path, then
    pack."""
    mark = mark or (lambda stage: None)
    B, L, W = cfg.B, cfg.L, cfg.W
    dev = codes.device
    lens = lens.to(I32)
    limit = limits.to(I32)
    best, overflow = _seed_vote(cfg, idx, codes, lens, mark)

    found, gi, strand, off, loc_fwd = _seq_lookup(idx, best, lens)
    safe_loc = torch.where(found, loc_fwd, 0).clamp(0, cfg.n - 1)
    # reverse-strand reads align their reverse complement
    q = torch.where(strand[:, None], codes_rc, codes).contiguous()
    t = _target_windows(cfg, idx, safe_loc)
    mark("locate_window")

    bidx = torch.arange(B, device=dev)
    overflow = overflow.to(I32)
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
        narrow = Wp < W
    ed_raw = wcol[lens.long(), bidx].to(I32)
    if narrow:
        # narrow first pass: values below Wp are exact; lanes whose ed'
        # reaches it (and whose limit the narrow band cannot certify) flag
        # bit 2 for the full-band retry and skip their walk here
        band_short = found & (ed_raw >= Wp) & (limit >= Wp)
        overflow = overflow | torch.where(band_short, 4, 0).to(I32)
    else:
        band_short = torch.zeros_like(found)
    # dead lanes (unmapped / over-limit: CIGAR '*') skip their walk
    alive = found & (ed_raw <= limit) & ~band_short
    lens_tb = torch.where(alive, lens, 0)
    if cfg.use_gact:
        # tiles are rematerialized in groups that fit the direction budget
        run_units, saturated = gact_traceback_c(
            q, t, ckpt, lens_tb, T, Wp, cfg.gact_band,
            scale=cfg.gact_runs_scale,
            group=gact_group_tiles(B, L, T, cfg.gact_band,
                                   cfg.mid_dirs_budget))
        mark("gact_walk")
        # a saturated shared run buffer can corrupt any lane's CIGAR: bit 1
        # sends the chunk to the mapper's saturation tier (a device-side
        # select: the host reads the flag with the blob)
        overflow = overflow | torch.where(saturated, 2, 0).to(I32)
    else:
        run_units = device_traceback_c(
            vdirs, lens_tb, L, Wp, nm,
            entry_dtype=torch.int16 if cfg.tb_entry_bytes == 2
            else torch.int32)
        mark("walk")
    K = cfg.tb_entry_bytes * run_units.shape[1]
    # a bit-2 lane's ed' is only an upper bound: never report it
    ed = torch.where((ed_raw <= limit) & ~band_short, ed_raw, -1)

    if cfg.pos64:
        # best and off as little-endian [lo, hi] int32 pairs
        b2 = best.to(torch.int64).contiguous().view(I32).reshape(B, 2)
        o2 = off.to(torch.int64).contiguous().view(I32).reshape(B, 2)
        meta = torch.stack([b2[:, 0], b2[:, 1], found.to(I32), gi,
                            strand.to(I32), o2[:, 0], o2[:, 1], ed, limit,
                            overflow], dim=1)
    else:
        meta = torch.stack([best.to(I32), found.to(I32), gi,
                            strand.to(I32), off.to(I32), ed, limit,
                            overflow], dim=1)
    # pad entries (op 3) to the back, path order kept (stable), then the
    # int16/int32 entries as little-endian bytes
    is_pad = ((run_units & 3) == 3).to(torch.int8)
    _, order = torch.sort(is_pad, dim=1, stable=True)
    compact = run_units.gather(1, order).contiguous().view(torch.int8)
    if cfg.use_gact:
        head = K          # long reads need ~2 entries per indel: all eager
    else:
        head = min(cfg.OPS_HEAD_COLS, K)
        head -= head % cfg.tb_entry_bytes
    meta_bytes = meta.contiguous().view(torch.int8).reshape(
        B, 4 * cfg.meta_words)
    blob = torch.cat([meta_bytes, compact[:, :head]], dim=1)
    mark("pack")
    return dict(blob=blob, ops_tail=compact[:, head:K])


def encode_raw(raw, L0: int):
    """(codes, codes_rc) of a (B, L) uint8 ASCII chunk whose reads are all
    L0 long (pad bytes 0): a/c/g/t of either case -> 0-3, every other byte
    -> 4, as the host encode's table; the reverse complement front-aligned
    with pad 4.  L0 comes from the host, so the roll costs no sync."""
    u = raw | 32                                   # fold ASCII case
    codes = torch.full_like(raw, 4, dtype=torch.int8)
    for c, ch in enumerate(b"acgt"):
        codes = torch.where(u == ch, c, codes)
    comp = torch.where(codes < 4, 3 - codes, codes)
    # the flipped row holds the read at [L - L0, L); rolling it left by
    # L - L0 front-aligns it and wraps the leading pad 4s to the tail
    codes_rc = torch.roll(comp.flip(1), L0 - raw.shape[1], dims=1)
    return codes, codes_rc


def raw_map_step(cfg: MapperConfig, idx: DeviceIndex, raw, lens, limits,
                 L0: int, mark=None):
    """map_step of a uniform chunk shipped as raw ASCII (B, L) uint8 on
    the index's device, its reads L0 long: the JAX raw_step.  Half the H2D
    bytes of the host encode's two int8 arrays; byte-identical output.
    `mark("encode")` follows the encode."""
    codes, codes_rc = encode_raw(raw, L0)
    if mark is not None:
        mark("encode")
    return map_step(cfg, idx, codes, codes_rc, lens, limits, mark)
