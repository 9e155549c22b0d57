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
one text_pair gather (`_ctx_window`).

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

The column traceback is the port's only walk.  On the card both walks are
CUDA kernels (csrc/walk.cu: one launch a resident pass, one a gact tile
group), so the step reads nothing back on the host but the seed vote's
wide-seed test (_narrow_wide_seeds).
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
from ..ops.rank import backward_step
from ..ops.traceback import device_traceback_c
from ..ops.vote import top2_small_histo, top2_votes
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


def _position_tables(cfg: MapperConfig, codes):
    """Per start position j in [0, npos): qw = 2-bit pack of
    codes[j .. j+left) (verify pattern), num = lchash key of
    codes[j+left .. j+seed_len) (first char most significant), ok = all
    seed_len codes < 4."""
    B, L = codes.shape
    sl, hlen, left, NP = cfg.seed_len, cfg.hlen, cfg.left, cfg.npos
    need = NP + sl
    c32 = codes.to(I32)
    if need > L:
        c32 = torch.cat([c32, torch.full((B, need - L), 4, dtype=I32,
                                         device=codes.device)], dim=1)
    qw = torch.zeros((B, NP), dtype=I32, device=codes.device)
    for t in range(left):
        qw |= c32[:, t:t + NP] << (2 * t)
    num = torch.zeros((B, NP), dtype=I32, device=codes.device)
    for t in range(hlen):
        num |= c32[:, left + t:left + t + NP] << (2 * (hlen - 1 - t))
    ok = torch.ones((B, NP), dtype=torch.bool, device=codes.device)
    for t in range(sl):
        ok &= c32[:, t:t + NP] < 4
    return qw, num, ok


def _by_phase(cfg: MapperConfig, a):
    """(B, npos) position-major -> (B*phases, max_seeds): j = it + s*step."""
    B = a.shape[0]
    return (a.reshape(B, cfg.max_seeds, cfg.phases).permute(0, 2, 1)
            .reshape(B * cfg.phases, cfg.max_seeds))


def _narrow_wide_seeds(cfg: MapperConfig, idx: DeviceIndex, wide,
                       k12, l12, cnt12, qw):
    """LF-narrow repeat-heavy seeds (hlen-mer interval >= thres) to their
    exact seed_len-mer intervals on at most cfg.wide_lanes compacted lanes,
    informative-filter them and scatter back.

    Returns (k_seed, cnt, row_overflow).  Batches with no wide seed skip
    the branch: one host sync (the JAX lax.cond)."""
    if not bool(wide.any()):
        return k12, cnt12, torch.zeros(wide.shape[0], dtype=torch.bool,
                                       device=wide.device)
    BP, S = wide.shape
    N = BP * S
    dev = wide.device
    flat_w = wide.reshape(-1)
    key = torch.where(flat_w, 0, 1).to(I32)
    key_s, sel = torch.sort(key, stable=True)
    sel = sel[:cfg.wide_lanes]
    sel_valid = key_s[:cfg.wide_lanes] == 0
    sel_safe = torch.where(sel_valid, sel, 0)
    k = k12.reshape(-1)[sel_safe]
    l = l12.reshape(-1)[sel_safe]
    qws = qw.reshape(-1)[sel_safe]
    for t in range(cfg.left - 1, -1, -1):
        c = (qws >> (2 * t)) & 3
        k, l = backward_step(idx.c4, idx.packed, idx.occ_samp,
                             cfg.dollar_pos, k, l, c, sel_valid & (k <= l))
    hits = torch.where(sel_valid & (k <= l), l - k + 1, 0)
    informative = (hits > 0) & (hits < cfg.thres)
    cnt_w = torch.where(informative, hits, 0).to(I32)

    # scatter back via a one-slot dump for unselected lanes
    tgt = torch.where(sel_valid, sel, N)

    def scat(base_flat, vals):
        padded = torch.cat([base_flat,
                            torch.zeros(1, dtype=base_flat.dtype,
                                        device=dev)])
        padded[tgt] = vals.to(base_flat.dtype)
        return padded[:N]

    cnt_base = torch.where(wide, 0, cnt12).reshape(-1)
    cnt = scat(cnt_base, cnt_w).reshape(BP, S)
    k_seed = scat(k12.reshape(-1), k).reshape(BP, S)
    picked = scat(torch.zeros(N, dtype=I32, device=dev),
                  sel_valid.to(I32)).reshape(BP, S) > 0
    row_overflow = (wide & ~picked).any(dim=1)
    return k_seed, cnt, row_overflow


def _join_hi(lo, hi):
    """(int32 low word, uint8 high byte) -> int64 position; the int32 word
    holds an unsigned value, so its sign is masked off."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def _ctx_window(cfg: MapperConfig, idx: DeviceIndex, sa12):
    """Slim-layout verify window: the ctx word _pack_ctx_words would have
    stored, rebuilt from one gather of the padded text pairs (rows
    [padded[w], padded[w+1]]; w0's +1 is the pad offset), shifted down to
    its top `left` bases.  start is in [-16, n-17]: >> and & 15 on int64
    give the floor semantics of the negative sub-word offsets, and the
    words are taken unsigned before they shift."""
    start = sa12.to(torch.int64) - 16
    w0 = (start >> 4) + 1
    o = start & 15
    pair = idx.text_pair[w0.clamp(0, idx.text_pair.shape[0] - 1)]
    lo = (pair[..., 0].to(torch.int64) & 0xFFFFFFFF) >> (2 * o)
    # o == 0 shifts the whole word out (JAX masks that lane to 0)
    hi = ((pair[..., 1].to(torch.int64) & 0xFFFFFFFF) << (32 - 2 * o)
          ) & 0xFFFFFFFF
    return (lo | hi) >> (2 * (16 - cfg.left))


def _slots_by_owner(C: int, cnt, k_seed, qw, j_ps, wide):
    """Slot -> seed assignment, seed-major / interval-rank-minor, for C
    slots per (read, phase) row: (p_rank, qw_slot, wide_slot, j_slot,
    total), with j_slot = -1 on empty slots.

    The seeds' slot ranges [cum - cnt, cum) are disjoint, so each occupied
    slot has exactly one owner, found by a binary search over `cum`; the
    JAX package reaches the same per-slot values through the (BP, S, C)
    owns-matrix reduce or, for long reads, a merge sort (_slots_by_sort).
    The search makes only (BP, C) temporaries, so it serves every size."""
    S = cnt.shape[1]
    dev = cnt.device
    cum = torch.cumsum(cnt, dim=1, dtype=I32)
    starts = cum - cnt
    slots = torch.arange(C, dtype=I32, device=dev)[None, :].expand(
        cum.shape[0], C).contiguous()
    owner = torch.searchsorted(cum, slots, right=True)    # (BP, C) int64
    occupied = owner < S
    own = owner.clamp(max=S - 1)

    def from_owner(x):
        return torch.where(occupied, x.gather(1, own), 0)

    p_rank = from_owner(k_seed - starts) + slots
    qw_slot = from_owner(qw)
    wide_slot = from_owner(wide.to(I32)) > 0
    j_slot = from_owner(j_ps + 1) - 1
    return p_rank, qw_slot, wide_slot, j_slot, cum[:, -1]


def _seed_vote(cfg: MapperConfig, idx: DeviceIndex, codes, lens):
    """All seeding phases in one batched pass; returns (best, overflow)."""
    B, P, S = cfg.B, cfg.phases, cfg.max_seeds
    left = cfg.left
    dev = codes.device

    qw_p, num_p, ok_p = _position_tables(cfg, codes)
    qw = _by_phase(cfg, qw_p)                          # (BP, S)
    num = _by_phase(cfg, num_p)
    ok = _by_phase(cfg, ok_p)

    # seed start offsets j = it + s*step
    j_ps = (torch.arange(P, dtype=I32, device=dev)[:, None]
            + cfg.step * torch.arange(S, dtype=I32, device=dev)[None, :]
            ).repeat(B, 1)
    lens_bp = lens.to(I32).repeat_interleave(P)        # (BP,)
    seed_ok = j_ps < (lens_bp[:, None] - cfg.seed_len)

    # lchash row gather; (0, 0) rows are absent k-mers.  pos64: (k, l)
    # ride as int32 low words beside uint8 high bytes
    safe_num = num.clamp(0, idx.lch.shape[0] - 1).long()
    kl = idx.lch[safe_num]
    if cfg.pos64:
        klh = idx.lch_hi[safe_num]
        k12 = _join_hi(kl[..., 0], klh[..., 0])
        l12 = _join_hi(kl[..., 1], klh[..., 1])
    else:
        k12 = kl[..., 0]
        l12 = kl[..., 1]
    present = ok & seed_ok & ~((k12 == 0) & (l12 == 0))
    cnt12 = torch.where(present, torch.clamp(l12 - k12 + 1, max=cfg.thres),
                        0).to(I32)
    wide = present & (cnt12 >= cfg.thres)
    k_seed, cnt, wide_overflow = _narrow_wide_seeds(
        cfg, idx, wide, k12, l12, cnt12, qw)

    CS = cfg.vote_slots
    p_rank, qw_slot, wide_slot, j_slot, total = _slots_by_owner(
        CS, cnt, k_seed, qw, j_ps, wide)
    valid = j_slot >= 0

    # one fused gather per vote: (SA value, packed 16-base left context);
    # the slim layout gathers the SA value alone
    p_safe = p_rank.clamp(0, cfg.n - 1).long()
    if cfg.slim:
        sa_low = idx.sa_ctx[p_safe]                          # (BP, C)
        sa12 = _join_hi(sa_low, idx.sa_hi[p_safe]) if cfg.pos64 else sa_low
    else:
        row = idx.sa_ctx[p_safe]                             # (BP, C, 2)
        sa12 = (_join_hi(row[..., 0], idx.sa_hi[p_safe]) if cfg.pos64
                else row[..., 0])
    if left > 0:
        if cfg.slim:
            win = _ctx_window(cfg, idx, sa12)
        else:
            win = ((row[..., 1].to(torch.int64) & 0xFFFFFFFF)
                   >> (2 * (16 - left)))
        qwu = qw_slot.to(torch.int64) & 0xFFFFFFFF
        verified = valid & (wide_slot | ((sa12 >= left) & (win == qwu)))
    else:
        verified = valid
    # int64 under pos64
    keys = sa12 - torch.where(wide_slot, 0, left).to(I32) - j_slot

    v1, key1, v2 = top2_votes(keys, verified)
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
    times them): seed_vote, locate_window, then band_dp + walk on the
    resident path or gact_forward + gact_walk on the gact path, then
    pack."""
    mark = mark or (lambda stage: None)
    B, L, W = cfg.B, cfg.L, cfg.W
    dev = codes.device
    lens = lens.to(I32)
    limit = limits.to(I32)
    best, overflow = _seed_vote(cfg, idx, codes, lens)
    mark("seed_vote")

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
