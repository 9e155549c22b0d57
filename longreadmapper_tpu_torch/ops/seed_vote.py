"""The seed vote's two device stages (port of the seeding and voting of
longreadmapper_tpu/mapping/pipeline.py::_seed_vote, which JAX leaves to
XLA gathers and sorts).

`seed_tables(cfg, idx, codes, lens)` — per seed (read b, phase p, seed s;
rows b*P + p, start j = p + s*step), in the (B*P, S) layout:
    qw     int32   2-bit pack of the seed's first `left` codes (verify)
    k12    pos     the hlen-mer's lchash interval start (0 if absent)
    cnt12  int32   min(interval width, thres) where the seed is present
    wide   bool    present and cnt12 >= thres (a repeat-heavy seed)
    kw, cw         a wide seed's LF-narrowed seed_len-mer interval start
                   and informative count (0 < hits < thres, else 0); k12
                   and 0 elsewhere
(pos: int32, int64 under pos64).  JAX narrows only the first wide_lanes
wide seeds of a chunk in flat order, on compacted lanes; the narrowing of
a seed depends on that seed alone, so the vote picks the narrowed values
of exactly those seeds (`pick_wide_seeds`: a rank, the flat cumsum of the
wide flags, `wide_rank`), with no host sync.

`vote_rows(cfg, idx, lens, tabs, rank)` — the pick, then per (read,
phase) row of C = cfg.vote_slots slots: slot c's owner is the seed whose
slot range [cum - cnt, cum) holds c; the slot gathers its `sa_ctx` row at
the owner's interval rank, verifies the seed's `left`-base prefix against
the row's context (the slim layout rebuilds it from one `text_pair` row),
and votes the diagonal key SA - left - j (SA - j for a wide seed); the
row's top-2 buckets (ops/vote.top2_votes); then each read's accept over
its P rows (`seed_accept_plain`).  Returns (best, overflow, rows): best
and overflow (B,), rows = (v1, key1, v2, total, wide_overflow), each
(B*P,), total the row's vote count (> C: the row overflowed).

On a CUDA tensor each launches its hand-written kernels in csrc/vote.cu
(seed_tables_kernel: a CTA a run of a read's seeds over its codes packed
in shared memory, the wide seeds narrowed after the main pass; the vote:
vote_warp_kernel, a warp
a row and a CTA a read, for rows of at most 512 slots, else
vote_cta_kernel, a CTA a row; each ends with the read's accept), counted
in `seed_tables.launches` / `vote_rows.launches`; on a CPU tensor each
runs its plain version, `seed_tables_plain` / `vote_accept_plain` (the
pick, `vote_rows_plain`, `seed_accept_plain`), the JAX step's ops in
PyTorch (their `cuda_calls` count calls on the card, which the card's map
path leaves at 0).  An index whose gather tables are `ShardedRows`
(parallel/dist.py) is gathered between two launches of each kernel: the
first writes the rows, the collective gathers them, the second reads
them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build
from .rank import backward_step
from .vote import (VOTE_FUNCS, pow2_at_least, row_scratch, top2_small_histo,
                   top2_votes_plain)

I32 = torch.int32
_STAGE_ALL, _STAGE_ROWS = 0, 1


# ------------------------------------------------------ the plain versions

def _position_tables(cfg, codes):
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


def _by_phase(cfg, a):
    """(B, npos) position-major -> (B*phases, max_seeds): j = it + s*step."""
    B = a.shape[0]
    return (a.reshape(B, cfg.max_seeds, cfg.phases).permute(0, 2, 1)
            .reshape(B * cfg.phases, cfg.max_seeds))


def _seed_starts(cfg, B: int, dev):
    """(B*P, S) int32 seed start offsets j = it + s*step."""
    P, S = cfg.phases, cfg.max_seeds
    return (torch.arange(P, dtype=I32, device=dev)[:, None]
            + cfg.step * torch.arange(S, dtype=I32, device=dev)[None, :]
            ).repeat(B, 1)


def _join_hi(lo, hi):
    """(int32 low word, uint8 high byte) -> int64 position; the int32 word
    holds an unsigned value, so its sign is masked off."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def _ctx_window(cfg, idx, sa12):
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


def seed_tables_plain(cfg, idx, codes, lens):
    """Plain version of seed_tables: the JAX step's shifted slices, one
    lchash row gather, and the LF narrowing of every wide seed on the
    compacted wide lanes (a host sync for their count)."""
    if codes.device.type == "cuda":
        seed_tables_plain.cuda_calls += 1
    B, P = codes.shape[0], cfg.phases
    dev = codes.device
    qw_p, num_p, ok_p = _position_tables(cfg, codes)
    qw = _by_phase(cfg, qw_p)                          # (BP, S)
    num = _by_phase(cfg, num_p)
    ok = _by_phase(cfg, ok_p)
    lens_bp = lens.to(I32).repeat_interleave(P)        # (BP,)
    seed_ok = _seed_starts(cfg, B, dev) < (lens_bp[:, None] - cfg.seed_len)

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

    kw = k12.clone()
    cw = torch.zeros_like(cnt12)
    sel = wide.reshape(-1).nonzero()[:, 0]
    if sel.numel():
        k = k12.reshape(-1)[sel]
        l = l12.reshape(-1)[sel]
        qws = qw.reshape(-1)[sel]
        for t in range(cfg.left - 1, -1, -1):
            c = (qws >> (2 * t)) & 3
            k, l = backward_step(idx.c4, idx.packed, idx.occ_samp,
                                 cfg.dollar_pos, k, l, c, k <= l)
        hits = torch.where(k <= l, l - k + 1, 0)
        kw.view(-1)[sel] = k.to(kw.dtype)
        cw.view(-1)[sel] = torch.where((hits > 0) & (hits < cfg.thres),
                                       hits, 0).to(I32)
    return qw, k12, cnt12, wide, kw, cw


seed_tables_plain.cuda_calls = 0


def _rows_gather(cfg, idx, p_safe):
    """The sa_ctx rows at p_safe (and sa_hi, and under slim the text pairs
    of each row's verify window): what the vote kernels gather themselves
    from replicated tables."""
    if cfg.slim:
        sa_low = idx.sa_ctx[p_safe]
        sa_hi = idx.sa_hi[p_safe] if cfg.pos64 else None
        pair = None
        if cfg.left > 0:
            sa12 = _join_hi(sa_low, sa_hi) if cfg.pos64 else sa_low
            w0 = ((sa12.to(torch.int64) - 16) >> 4) + 1
            pair = idx.text_pair[w0.clamp(0, idx.text_pair.shape[0] - 1)]
        return sa_low, sa_hi, pair
    return (idx.sa_ctx[p_safe], idx.sa_hi[p_safe] if cfg.pos64 else None,
            None)


def slot_votes(cfg, idx, k_seed, cnt, qw, wide):
    """Each row's C votes before the top-2: (keys (B*P, C) int32 or int64,
    verified (B*P, C) bool, total (B*P,)), by the owner search, one fused
    gather per slot and the verify."""
    left = cfg.left
    j_ps = _seed_starts(cfg, cnt.shape[0] // cfg.phases, cnt.device)
    p_rank, qw_slot, wide_slot, j_slot, total = _slots_by_owner(
        cfg.vote_slots, cnt, k_seed, qw, j_ps, wide)
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
    return keys, verified, total


def vote_rows_plain(cfg, idx, k_seed, cnt, qw, wide):
    """Plain version of vote_rows: slot_votes, then the stable-sort top-2
    in PyTorch ops."""
    if cnt.device.type == "cuda":
        vote_rows_plain.cuda_calls += 1
    keys, verified, total = slot_votes(cfg, idx, k_seed, cnt, qw, wide)
    v1, key1, v2 = top2_votes_plain(keys, verified)
    return v1, key1, v2, total


vote_rows_plain.cuda_calls = 0


def vote_need(cfg, tabs):
    """Each read's widest (read, phase) row as the exact tier votes it,
    (B,) int32: a row's slots are its seeds' counts, each wide seed at its
    narrowed count cw, as a step whose pick keeps every wide seed gives
    them (the pick of a batch keeps the first wide_lanes, so the row a
    step votes is never wider).  Plain PyTorch on either device."""
    _, _, cnt12, wide, _, cw = tabs
    return torch.where(wide, cw, cnt12).sum(1, dtype=I32).reshape(
        -1, cfg.phases).amax(1)


def wide_rank(wide):
    """The flat inclusive count of wide seeds, (B*P*S,) int32: a wide
    seed's rank among the chunk's wide seeds in flat order."""
    return torch.cumsum(wide.reshape(-1), 0, dtype=I32)


def pick_wide_seeds(cfg, wide, k12, cnt12, kw, cw, rank):
    """The narrowed wide seeds JAX keeps: its _narrow_wide_seeds compacts
    the first cfg.wide_lanes wide seeds of the chunk in flat order onto
    its lanes (a stable sort), LF-narrows them and scatters them back; the
    rest vote nothing and flag their row.  seed_tables has narrowed every
    wide seed already (kw, cw), so picking is a rank (`wide_rank`): a wide
    seed is kept when at most wide_lanes wide seeds come before it and
    itself.  No branch and no host sync: with no wide seed it returns
    (k12, cnt12, no overflow), JAX's lax.cond's other branch.

    Returns (k_seed, cnt, row_overflow)."""
    flat = wide.reshape(-1)
    picked = (flat & (rank <= min(cfg.wide_lanes, flat.shape[0]))
              ).reshape(wide.shape)
    k_seed = torch.where(picked, kw, k12)
    cnt = torch.where(wide, torch.where(picked, cw, 0), cnt12)
    return k_seed, cnt, (wide & ~picked).any(dim=1)


def seed_accept_plain(cfg, lens, v1, key1, v2, total, wide_overflow):
    """Plain version of the reads' accept (the end of JAX's _seed_vote,
    alnmain.c:375-403) over the rows' top-2, each (B*P,): per phase,
    (v1 + v2) / num_seeds > accept_score as an exact rational; the first
    accepted phase's key1, or the outer histogram's top-1 over the earlier
    phases with v1 != 0 when no phase or the last one accepted; overflow
    over the executed phases.  Returns (best, overflow), each (B,)."""
    if v1.device.type == "cuda":
        seed_accept_plain.cuda_calls += 1
    B, P = cfg.B, cfg.phases
    dev = v1.device
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
    per_phase_ovf = ((total > cfg.vote_slots) | wide_overflow).reshape(B, P)
    overflow = (per_phase_ovf & executed).any(dim=1)
    return best, overflow


seed_accept_plain.cuda_calls = 0


def vote_accept_plain(cfg, idx, lens, tabs, rank):
    """Plain version of vote_rows: pick_wide_seeds, vote_rows_plain and
    seed_accept_plain."""
    qw, k12, cnt12, wide, kw, cw = tabs
    k_seed, cnt, wide_overflow = pick_wide_seeds(cfg, wide, k12, cnt12, kw,
                                                 cw, rank)
    rows = vote_rows_plain(cfg, idx, k_seed, cnt, qw, wide) + (
        wide_overflow,)
    return seed_accept_plain(cfg, lens, *rows) + (rows,)


# ------------------------------------------------------------- the kernels

class TablesArgs(ctypes.Structure):
    """csrc/vote.cu::TablesArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("codes", "lens", "lch", "lch_hi", "c4", "packed", "occ",
                 "qw", "k12", "cnt12", "wide", "kw", "cw", "rows")] + [
        (k, ctypes.c_int64) for k in
        ("H", "npw", "nocc", "dollar_pos", "B", "L", "P", "S", "step",
         "seed_len", "hlen", "left", "thres", "pos64", "c4_64", "occ_64",
         "pre", "stage")]


class RowsArgs(ctypes.Structure):
    """csrc/vote.cu::RowsArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("cnt12", "k12", "kw", "cw", "rank", "qw", "wide", "lens",
                 "sa_ctx", "sa_hi", "text_pair", "rows", "v1", "key1", "v2",
                 "total", "row_ovf", "best", "overflow", "tickets",
                 "scratch")] + [
        (k, ctypes.c_int64) for k in
        ("B", "P", "S", "step", "C", "Cpad", "n", "m_pair", "left",
         "lanes", "nacc", "dacc", "pos64", "slim", "pre", "stage",
         "use_global", "row_bytes")]


# a device's read counters for the vote's accept (vote_cta_kernel's
# tickets): zeroed once, left at 0 by every launch; launches that share
# them run in order on one stream, as the mapping step's do
_TICKETS: dict = {}


def _tickets(dev, B: int):
    t = _TICKETS.get(dev)
    if t is None or t.numel() < B:
        t = _TICKETS[dev] = torch.zeros(max(B, 4096), dtype=I32, device=dev)
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sharded(idx, *names) -> bool:
    """True when a gather table is not a tensor on this device (a
    ShardedRows block of a row-sharded index)."""
    return any(not isinstance(getattr(idx, k), torch.Tensor) for k in names
               if getattr(idx, k) is not None)


def _check(name: str, dev, tensors: dict) -> None:
    for k, t in tensors.items():
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {k} on {t.device}, contiguous "
                             f"{t.is_contiguous()}; needs a contiguous "
                             f"tensor on {dev}")


def _call(lib, fn: str, args, stream) -> None:
    err = getattr(lib, fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: error {err}")


def _stream(dev):
    """The raw handle of `dev`'s current stream (what
    torch.cuda.current_stream(dev).cuda_stream gives, without building a
    Stream object)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def seed_tables(cfg, idx, codes, lens):
    """(qw, k12, cnt12, wide, kw, cw), each (B*P, S): one launch of
    seed_tables_kernel on CUDA tensors (two over a row-sharded lchash),
    the plain version on CPU tensors."""
    if codes.device.type == "cpu":
        return seed_tables_plain(cfg, idx, codes, lens)
    lib = native_build.load("vote", VOTE_FUNCS)
    with torch.cuda.device(codes.device):
        return _seed_tables_run(lib, _stream(codes.device), cfg, idx, codes,
                                lens)


def _seed_tables_run(lib, stream, cfg, idx, codes, lens):
    """seed_tables through `lib`'s lrm_seed_tables on `stream`."""
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise TypeError(f"codes must be (B, L) int8, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    dev = codes.device
    B, L = codes.shape
    P, S = cfg.phases, cfg.max_seeds
    N = B * P * S
    if tuple(lens.shape) != (B,):
        raise ValueError(f"lens {tuple(lens.shape)} for codes of {B} reads")
    codes = codes.contiguous()
    lens = lens.to(I32).contiguous()
    pdt = torch.int64 if cfg.pos64 else I32
    out = dict(qw=torch.empty(N, dtype=I32, device=dev),
               k12=torch.empty(N, dtype=pdt, device=dev),
               cnt12=torch.empty(N, dtype=I32, device=dev),
               wide=torch.empty(N, dtype=torch.bool, device=dev),
               kw=torch.empty(N, dtype=pdt, device=dev),
               cw=torch.empty(N, dtype=I32, device=dev))
    c4, occ = idx.c4.contiguous(), idx.occ_samp.contiguous()
    if c4.dtype not in (I32, torch.int64) or occ.dtype not in (
            I32, torch.int64):
        raise TypeError(f"c4 {c4.dtype}, occ_samp {occ.dtype}: int32 or "
                        "int64")
    lch, lch_hi = idx.lch, idx.lch_hi if cfg.pos64 else None
    _check("seed_tables", dev, dict(lens=lens, c4=c4, packed=idx.packed,
                                    occ_samp=occ))
    fields = dict(
        codes=codes.data_ptr(), lens=lens.data_ptr(), c4=c4.data_ptr(),
        packed=idx.packed.data_ptr(), occ=occ.data_ptr(),
        **{k: v.data_ptr() for k, v in out.items()},
        H=lch.shape[0], npw=idx.packed.shape[0], nocc=occ.shape[0],
        dollar_pos=cfg.dollar_pos, B=B, L=L, P=P, S=S, step=cfg.step,
        seed_len=cfg.seed_len, hlen=cfg.hlen, left=cfg.left, thres=cfg.thres,
        pos64=int(cfg.pos64), c4_64=int(c4.dtype == torch.int64),
        occ_64=int(occ.dtype == torch.int64))
    if _sharded(idx, "lch", "lch_hi"):
        # the rows first, then the collective gathers them, then the tables
        rows = torch.empty(N, dtype=torch.int64, device=dev)
        _call(lib, "lrm_seed_tables", TablesArgs(
            **fields, lch=0, lch_hi=0, rows=rows.data_ptr(), pre=0,
            stage=_STAGE_ROWS), stream)
        seed_tables.launches += 1
        lch = lch[rows].contiguous()
        lch_hi = lch_hi[rows].contiguous() if cfg.pos64 else None
        pre = 1
    else:
        pre = 0
    if lch.dtype != I32 or (cfg.pos64 and lch_hi.dtype != torch.uint8):
        raise TypeError(f"lch must be int32 (lch_hi uint8), got {lch.dtype}")
    _check("seed_tables", dev, dict(lch=lch, lch_hi=lch_hi))
    _call(lib, "lrm_seed_tables", TablesArgs(
        **fields, lch=lch.data_ptr(), lch_hi=_ptr(lch_hi), rows=None,
        pre=pre, stage=_STAGE_ALL), stream)
    seed_tables.launches += 1
    return tuple(out[k].reshape(B * P, S)
                 for k in ("qw", "k12", "cnt12", "wide", "kw", "cw"))


seed_tables.launches = 0


def vote_rows(cfg, idx, lens, tabs, rank):
    """(best, overflow, (v1, key1, v2, total, wide_overflow)) of
    seed_tables' `tabs` and `wide_rank`'s `rank`: one launch of the vote
    kernel on CUDA tensors (two over row-sharded tables), the plain
    version on CPU tensors."""
    if lens.device.type == "cpu":
        return vote_accept_plain(cfg, idx, lens, tabs, rank)
    lib = native_build.load("vote", VOTE_FUNCS)
    with torch.cuda.device(lens.device):
        return _vote_rows_run(lib, _stream(lens.device), cfg, idx, lens,
                              tabs, rank)


def _vote_rows_run(lib, stream, cfg, idx, lens, tabs, rank):
    """vote_rows through `lib`'s lrm_vote_rows on `stream`."""
    dev = lens.device
    qw, k12, cnt12, wide, kw, cw = tabs
    B, P = cfg.B, cfg.phases
    BP, S = cnt12.shape
    C = cfg.vote_slots
    Cpad = pow2_at_least(C)
    pdt = torch.int64 if cfg.pos64 else I32
    if (cnt12.dtype != I32 or qw.dtype != I32 or cw.dtype != I32
            or k12.dtype != pdt or kw.dtype != pdt
            or wide.dtype != torch.bool or rank.dtype != I32):
        raise TypeError(f"cnt12, qw, cw, rank int32, k12, kw {pdt}, wide "
                        f"bool; got {cnt12.dtype}, {qw.dtype}, {cw.dtype}, "
                        f"{rank.dtype}, {k12.dtype}, {kw.dtype}, "
                        f"{wide.dtype}")
    if BP != B * P or tuple(lens.shape) != (B,):
        raise ValueError(f"vote_rows: {BP} rows, lens {tuple(lens.shape)}; "
                         f"needs {B} reads of {P} rows")
    for name, t in (("k12", k12), ("kw", kw), ("cw", cw), ("qw", qw),
                    ("wide", wide)):
        if tuple(t.shape) != (BP, S):
            raise ValueError(f"vote_rows: {name} {tuple(t.shape)}, cnt12 "
                             f"{(BP, S)}")
    if rank.numel() != BP * S:
        raise ValueError(f"vote_rows: rank of {rank.numel()}, not {BP * S}")
    ins = {k: t.contiguous() for k, t in dict(
        cnt12=cnt12, k12=k12, kw=kw, cw=cw, rank=rank, qw=qw, wide=wide,
        lens=lens.to(I32)).items()}
    _check("vote_rows", dev, ins)
    out = dict(v1=torch.empty(BP, dtype=I32, device=dev),
               key1=torch.empty(BP, dtype=pdt, device=dev),
               v2=torch.empty(BP, dtype=I32, device=dev),
               total=torch.empty(BP, dtype=I32, device=dev),
               row_ovf=torch.empty(BP, dtype=torch.bool, device=dev),
               best=torch.empty(B, dtype=pdt, device=dev),
               overflow=torch.empty(B, dtype=torch.bool, device=dev))
    use_global, row_bytes, scratch = row_scratch(lib, BP, Cpad, S,
                                                 cfg.pos64, dev)
    nacc, dacc = cfg.accept_frac
    fields = dict(
        **{k: t.data_ptr() for k, t in ins.items()},
        **{k: t.data_ptr() for k, t in out.items()},
        tickets=_tickets(dev, B).data_ptr(), scratch=_ptr(scratch),
        B=B, P=P, S=S, step=cfg.step, C=C, Cpad=Cpad, n=cfg.n,
        left=cfg.left, lanes=min(cfg.wide_lanes, BP * S), nacc=nacc,
        dacc=dacc, pos64=int(cfg.pos64), slim=int(cfg.slim),
        use_global=use_global, row_bytes=row_bytes)
    names = ("sa_ctx", "sa_hi", "text_pair")
    if _sharded(idx, *names):
        # the rows first, then the collectives gather them, then the votes
        rows = torch.empty((BP, C), dtype=torch.int64, device=dev)
        _call(lib, "lrm_vote_rows", RowsArgs(
            **fields, sa_ctx=None, sa_hi=None, text_pair=None,
            rows=rows.data_ptr(), m_pair=1, pre=0, stage=_STAGE_ROWS),
            stream)
        vote_rows.launches += 1
        tables = [None if t is None else t.contiguous()
                  for t in _rows_gather(cfg, idx, rows)]
        pre, m_pair = 1, BP * C
    else:
        tables = [getattr(idx, k) for k in names]
        tables[1] = tables[1] if cfg.pos64 else None
        tables[2] = tables[2] if cfg.slim else None
        pre = 0
        m_pair = tables[2].shape[0] if tables[2] is not None else 0
    sa_ctx, sa_hi, pair = tables
    if sa_ctx.dtype != I32 or (sa_hi is not None
                               and sa_hi.dtype != torch.uint8):
        raise TypeError(f"sa_ctx int32, sa_hi uint8; got {sa_ctx.dtype}")
    if cfg.slim and cfg.left > 0 and pair is None:
        raise ValueError("the slim layout verifies through text_pair")
    _check("vote_rows", dev, dict(sa_ctx=sa_ctx, sa_hi=sa_hi,
                                  text_pair=pair))
    _call(lib, "lrm_vote_rows", RowsArgs(
        **fields, sa_ctx=sa_ctx.data_ptr(), sa_hi=_ptr(sa_hi),
        text_pair=_ptr(pair), rows=None, m_pair=m_pair, pre=pre,
        stage=_STAGE_ALL), stream)
    vote_rows.launches += 1
    return out["best"], out["overflow"], tuple(
        out[k] for k in ("v1", "key1", "v2", "total", "row_ovf"))


vote_rows.launches = 0
