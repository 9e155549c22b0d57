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
a seed depends on that seed alone, so the step picks the narrowed values
of exactly those seeds (mapping/pipeline._pick_wide_seeds), with no host
sync.

`vote_rows(cfg, idx, k_seed, cnt, qw, wide)` — per (read, phase) row of
C = cfg.vote_slots slots: slot c's owner is the seed whose slot range
[cum - cnt, cum) holds c; the slot gathers its `sa_ctx` row at the
owner's interval rank, verifies the seed's `left`-base prefix against the
row's context (the slim layout rebuilds it from one `text_pair` row), and
votes the diagonal key SA - left - j (SA - j for a wide seed); then the
row's top-2 buckets (ops/vote.top2_votes).  Returns (v1, key1, v2,
total), total = the row's vote count (> C: the row overflowed).

On a CUDA tensor each launches its hand-written kernel in
csrc/vote.cu (seed_tables_kernel: a thread a seed; vote_rows_kernel: a
CTA a row), counted in `seed_tables.launches` / `vote_rows.launches`; on
a CPU tensor each runs its plain version, `seed_tables_plain` /
`vote_rows_plain`, the JAX step's ops in PyTorch (their `cuda_calls`
count calls on the card, which the card's map path leaves at 0).  An
index whose gather tables are `ShardedRows` (parallel/dist.py) is
gathered between two launches of each kernel: the first writes the rows,
the collective gathers them, the second reads them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build
from .rank import backward_step
from .vote import (VOTE_FUNCS, pow2_at_least, row_scratch,
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
    of each row's verify window): what vote_rows_kernel gathers itself
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
                ("cnt", "kseed", "qw", "wide", "sa_ctx", "sa_hi",
                 "text_pair", "rows", "v1", "key1", "v2", "total",
                 "scratch")] + [
        (k, ctypes.c_int64) for k in
        ("BP", "P", "S", "step", "C", "Cpad", "n", "m_pair", "left",
         "pos64", "slim", "pre", "stage", "use_global", "row_bytes")]


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
    return torch.cuda.current_stream(dev).cuda_stream


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


def vote_rows(cfg, idx, k_seed, cnt, qw, wide):
    """(v1, key1, v2, total), each (B*P,): one launch of vote_rows_kernel on
    CUDA tensors (two over row-sharded tables), the plain version on CPU
    tensors."""
    if cnt.device.type == "cpu":
        return vote_rows_plain(cfg, idx, k_seed, cnt, qw, wide)
    lib = native_build.load("vote", VOTE_FUNCS)
    with torch.cuda.device(cnt.device):
        return _vote_rows_run(lib, _stream(cnt.device), cfg, idx, k_seed,
                              cnt, qw, wide)


def _vote_rows_run(lib, stream, cfg, idx, k_seed, cnt, qw, wide):
    """vote_rows through `lib`'s lrm_vote_rows on `stream`."""
    dev = cnt.device
    BP, S = cnt.shape
    C = cfg.vote_slots
    Cpad = pow2_at_least(C)
    pdt = torch.int64 if cfg.pos64 else I32
    if (cnt.dtype != I32 or qw.dtype != I32 or k_seed.dtype != pdt
            or wide.dtype != torch.bool):
        raise TypeError(f"cnt, qw int32, k_seed {pdt}, wide bool; got "
                        f"{cnt.dtype}, {qw.dtype}, {k_seed.dtype}, "
                        f"{wide.dtype}")
    for name, t in (("k_seed", k_seed), ("qw", qw), ("wide", wide)):
        if tuple(t.shape) != (BP, S):
            raise ValueError(f"vote_rows: {name} {tuple(t.shape)}, cnt "
                             f"{(BP, S)}")
    cnt, k_seed, qw = cnt.contiguous(), k_seed.contiguous(), qw.contiguous()
    wide = wide.contiguous()
    _check("vote_rows", dev, dict(k_seed=k_seed, qw=qw, wide=wide))
    v1 = torch.empty(BP, dtype=I32, device=dev)
    key1 = torch.empty(BP, dtype=pdt, device=dev)
    v2 = torch.empty(BP, dtype=I32, device=dev)
    total = torch.empty(BP, dtype=I32, device=dev)
    use_global, row_bytes, scratch = row_scratch(BP, 12 * Cpad + 4 * S, dev)
    fields = dict(
        cnt=cnt.data_ptr(), kseed=k_seed.data_ptr(), qw=qw.data_ptr(),
        wide=wide.data_ptr(), v1=v1.data_ptr(), key1=key1.data_ptr(),
        v2=v2.data_ptr(), total=total.data_ptr(), scratch=_ptr(scratch),
        BP=BP, P=cfg.phases, S=S, step=cfg.step, C=C, Cpad=Cpad, n=cfg.n,
        left=cfg.left, pos64=int(cfg.pos64), slim=int(cfg.slim),
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
    return v1, key1, v2, total


vote_rows.launches = 0
