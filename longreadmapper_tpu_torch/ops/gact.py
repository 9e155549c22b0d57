"""Tiled long-read alignment: the checkpointed banded DP and its
rematerialized column walk (port of longreadmapper_tpu/ops/gact.py:
gact_forward, gact_runs_cols_c, gact_traceback_c).

forward pass   — the banded DP over all L rows keeps only every T-th row
                 (the checkpoints) and the band-centre score column:
                 O(L/T * band) memory instead of O(L * band).
traceback pass — tiles replay newest first; each tile's vertical direction
                 words and its group bitmap are recomputed from its
                 checkpoint row (ops/band_dp.banded_nw_dirs with an entry
                 row: the wide CUDA kernel on the card), then the
                 column-consuming walk crosses the tile one M-run plus one
                 indel per iteration, as ops/traceback.device_traceback_c.

`gact_forward` here is the plain version; on the card the step calls
ops/band_scores.band_checkpoints, whose kernel has the same contract.  The
walk stays eager PyTorch with one host sync per iteration (the JAX
while_loop's `any(alive)`).
"""

from __future__ import annotations

import torch

from .band_dp import banded_nw_dirs
from .traceback import OP_PAD, group_below, msb32
from .wavefront import dp_rows, row0

_MASK32 = 0xFFFFFFFF


def gact_forward(q, t, T: int, W: int, band: int):
    """q (B, L) query codes (pad 4), t (B, L) target codes (pad/'$' 5),
    L % T == 0, T % 16 == 0.  Returns (ckpt (L/T+1, B, band) int32 — ckpt[k]
    is H row k*T —, wcol (L+1, B) int16 — wcol[i] = H[i, W])."""
    if q.device.type == "cuda":
        gact_forward.cuda_calls += 1
    B, L = q.shape
    assert L % T == 0 and T % 16 == 0
    h0 = row0(B, L, W, band, q.device)
    ckpt = torch.empty((L // T + 1, B, band), dtype=torch.int32,
                       device=q.device)
    wcol = torch.empty((L + 1, B), dtype=torch.int16, device=q.device)
    ckpt[0] = h0
    wcol[0] = h0[:, W].to(torch.int16)
    for i, row, _ in dp_rows(q, t, W, band, h0, 0, L, with_dirs=False):
        wcol[i] = row[:, W].to(torch.int16)
        if i % T == 0:
            ckpt[i // T] = row
    return ckpt, wcol


gact_forward.cuda_calls = 0


def gact_runs_cols_c(L: int, T: int, W: int, scale: int = 1) -> int:
    """Run-entry columns of gact_traceback_c: 2 entries per buffer row;
    rows = 2W indel rows (the per-tile max can land on different lanes)
    times `scale` (the saturation retry tier's multiplier), one per tile,
    plus slack."""
    return 2 * (scale * 2 * W + 2 * (L // T) + 16)


def gact_traceback_c(q, t, ckpt, lens, T: int, W: int, band: int,
                     scale: int = 1):
    """Column-consuming rematerialized walk.  lens (B,) with dead lanes
    (unmapped / over-limit) masked to 0 by the caller.

    Returns (runs (B, gact_runs_cols_c(L, T, W, scale)) int16 entries
    (count << 2 | op) in reverse path order with pad gaps between tiles,
    saturated): all lanes share one write pointer that clamps at the last
    buffer row; `saturated` is True when that row took two or more writes
    (every lane's runs are then suspect)."""
    B, L = q.shape
    K = L // T
    G = T // 16
    if T > 8191 or band - W > 8191:
        # the reference's own bound (JAX ops/gact.py:310; ROADMAP.md C):
        # (count << 2) of an int16 entry holds counts < 8192
        raise ValueError(f"gact run counts overflow int16 entries: T={T}, "
                         f"band - W = {band - W} (both must be <= 8191; "
                         "reads past ~80 kb, ROADMAP.md C)")
    dev = q.device
    i64 = torch.int64
    bidx = torch.arange(B, dtype=i64, device=dev)
    n_rows = gact_runs_cols_c(L, T, W, scale) // 2
    tile_bound = W + 4                 # iterations = indels in tile + slack
    i = lens.to(i64)
    j = i.clone()
    done = i <= 0
    buf = torch.full((n_rows, B, 2), OP_PAD, dtype=torch.int16, device=dev)
    ptr = nsat = syncs = 0
    for k in range(K - 1, -1, -1):
        lo = k * T
        vdirs, _, nm = banded_nw_dirs(q, t, W, band, h0=ckpt[k], i0=lo, n=T)
        Vf = vdirs.reshape(-1)
        nmf = [nm[w].reshape(-1) for w in range(nm.shape[0])]

        def word_at(g, d):
            flat = ((g * B + bidx) * band + d).clamp(0, G * B * band - 1)
            return Vf[flat].to(i64) & _MASK32

        it = 0
        while it < tile_bound:
            alive = ~done & ((i > lo) | ((k == 0) & (j > 0)))
            syncs += 1
            if not bool(alive.any()):
                break
            in_tile = i > lo
            active = ~done & (in_tile | ((k == 0) & (j > 0)))
            d = (j - i + W).clamp(0, band - 1)
            ii = (i - 1 - lo).clamp(0, T - 1)        # row within the tile
            g_cur, r = ii >> 4, ii & 15
            w_cur = word_at(g_cur, d)
            sh = 2 * (15 - r)
            wm_cur = ((w_cur << sh) & _MASK32) >> sh   # pairs above i off
            in_cur = (wm_cur != 0) & in_tile
            # highest group strictly below g_cur with a non-M pair
            g2 = group_below(nmf, (bidx * band + d).clamp(0, B * band - 1),
                             g_cur)
            has_below = (g2 >= 0) & in_tile
            any_nm = active & in_tile & (in_cur | has_below)
            gstar = torch.where(in_cur, g_cur, g2.clamp(min=0))
            wsel = torch.where(in_cur, wm_cur, word_at(gstar, d))
            # 15 - (clz(wsel) >> 1): the lowest row of the word with a non-M
            pstar = (15 - ((31 - msb32(wsel)) >> 1)).clamp(min=0)
            # M-run floor: the indel row, else the tile entry (row 0 in
            # tile 0: the walk then owes only the synthetic all-D row)
            floor_row = torch.where(any_nm, lo + gstar * 16 + pstar + 1,
                                    0 if k == 0 else lo)
            mrun = torch.where(active & in_tile, i - floor_row, 0)
            i2 = i - mrun
            j2 = j - mrun
            op = (wsel >> (2 * pstar)) & 3
            take_e = any_nm & ~((i2 == 0) & (j2 == 0))
            i3 = torch.where(take_e & (op == 1), i2 - 1, i2)
            j3 = torch.where(take_e & (op == 2), j2 - 1, j2)
            drun = torch.where(active & ~any_nm & (i2 == 0), j2.clamp(min=0),
                               0)
            j4 = torch.where(drun > 0, 0, j3)
            done = done | ((i3 == 0) & (j4 == 0))
            e1 = torch.where(mrun > 0, mrun << 2, OP_PAD)
            e2 = torch.where(take_e, 4 | op,
                             torch.where(drun > 0, (drun << 2) | 2, OP_PAD))
            buf[ptr, :, 0] = e1.to(torch.int16)
            buf[ptr, :, 1] = e2.to(torch.int16)
            # writes that land on the clamped last row: the first is
            # legitimate, every later one overwrites it for all lanes
            nsat += ptr == n_rows - 1
            ptr = min(ptr + 1, n_rows - 1)
            i, j = i3, j4
            it += 1
    gact_traceback_c.host_syncs += syncs
    return buf.permute(1, 0, 2).reshape(B, -1), nsat >= 2


gact_traceback_c.host_syncs = 0
