"""Tiled long-read alignment: the checkpointed banded DP and its
rematerialized column walk (port of longreadmapper_tpu/ops/gact.py:
gact_forward, gact_runs_cols_c, gact_traceback_c).

forward pass   — the banded DP over all L rows keeps only every T-th row
                 (the checkpoints) and the band-centre score column:
                 O(L/T * band) memory instead of O(L * band).
traceback pass — tiles replay newest first, in groups: each group's
                 vertical direction words and group bitmaps are recomputed
                 from the tiles' checkpoint rows at once
                 (ops/band_dp.banded_nw_dirs_tiles: one launch of the wide
                 CUDA kernel on the card), newest group first, as many
                 tiles a group as fit in the caller's direction budget;
                 then the column-consuming walk crosses the group's tiles
                 one by one, one M-run plus one indel per iteration, as
                 ops/traceback.device_traceback_c.  The grouping changes
                 no output: the walk sees the same words in the same
                 order.

`gact_forward` here is the plain version; on the card the step calls
ops/band_scores.band_checkpoints, whose kernel has the same contract.
`gact_traceback_c` walks each group in one launch of the hand-written CUDA
kernel csrc/walk.cu::gact_walk_kernel on CUDA tensors (counted in
`gact_traceback_c.launches`), right after the group's direction kernel,
with no host sync: a warp a lane, each lane at its own pace, the group's
last CTA placing the lanes' pairs on the rows of the shared write
pointer.  Before the first group one launch of csrc/step.cu::lanes_kernel
(ops/step.py::gact_setup) writes the walk's state from each lane's walk
length (given, or computed from G3's inputs, a step.Lanes, whose values
for the pack it writes too) and fills the run buffer with pads;
`gact_traceback_c_state` is the walk from that prepared state.  On CPU
tensors it runs the plain version
`gact_traceback_c_plain`, eager PyTorch in lock step with one host sync
per iteration (the JAX while_loop's `any(alive)`, counted in
`gact_traceback_c.host_syncs`).

Run entries are (count << 2) | op in the caller's `entry_dtype`: int16
holds counts to 8191, int32 to 2^29 - 1.  A walk's counts reach max(T,
band - W) (an M-run ends at its tile's floor; the row-0 D-run is shorter
than band - W), so the step takes int32 where that passes 8191
(mapping/pipeline.MapperConfig.tb_entry_bytes: the full-band retry of
reads past ~80 kb).  JAX's walk keeps int16 entries and refuses those
shapes (its ops/gact.py:310); here only a count that would overflow the
entries asked for raises (ROADMAP.md section C).
"""

from __future__ import annotations

import torch

from .. import native_build
from . import step
from .band_dp import banded_nw_dirs_tiles
from .seed_vote import _stream
from .traceback import (OP_PAD, WALK_FUNCS, check_run_counts, group_below,
                        msb32)
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


def gact_group_tiles(B: int, L: int, T: int, band: int, budget: int) -> int:
    """Tiles per rematerialization group: as many as the bytes of their
    direction words, bitmaps and centre columns fit in `budget` (at least
    one, at most all L/T)."""
    G = T // 16
    tile_bytes = 4 * B * band * (G + -(-G // 32)) + 2 * B * (T + 1)
    return max(1, min(L // T, budget // tile_bytes))


def _for_each_group(q, t, ckpt, T: int, W: int, band: int, group: int,
                    walk, mark):
    """Rematerialize the tiles newest first, `group` at a time, and call
    walk(k_lo, k_hi, vg, nmg) on each group's direction words and bitmaps;
    mark("dirs") after each group's rematerialization and mark("walk")
    after its walk, when `mark` is given."""
    K = q.shape[1] // T
    k_hi = K - 1
    while k_hi >= 0:
        k_lo = max(0, k_hi - group + 1)
        vg, _, nmg = banded_nw_dirs_tiles(q, t, W, band, ckpt, T, k_lo,
                                          k_hi - k_lo + 1)
        if mark:
            mark("dirs")
        walk(k_lo, k_hi, vg, nmg)
        if mark:
            mark("walk")
        # free the group before the next one is allocated: two would not
        # fit the budget
        del vg, nmg
        k_hi = k_lo - 1


def gact_traceback_c(q, t, ckpt, lens, T: int, W: int, band: int,
                     scale: int = 1, group: int = 1, mark=None, iters=None,
                     entry_dtype=torch.int16):
    """Column-consuming rematerialized walk.  lens (B,) with dead lanes
    (unmapped / over-limit) masked to 0 by the caller, or G3 as a
    step.Lanes (its lens_tb); `group` tiles are rematerialized at a time
    (gact_group_tiles); `mark` as _for_each_group's; `iters`, when given,
    an int32 (L/T, B) tensor on the input's device that receives each
    lane's iterations in each tile; `entry_dtype` the run entries', int16
    or int32 (raises ValueError where max(T, band - W) passes what its
    count field holds, traceback.check_run_counts).

    Returns (runs (B, gact_runs_cols_c(L, T, W, scale)) entries (count <<
    2 | op) in `entry_dtype`, in reverse path order with pad gaps between
    tiles, saturated): all lanes share one write pointer that clamps at
    the last buffer row; `saturated`, a 0-dim bool tensor on the input's
    device, is True when that row took two or more writes (every lane's
    runs are then suspect).  On CUDA tensors one launch of
    step.gact_setup, then one of gact_walk_kernel a group (raises for what
    it does not take); on CPU tensors the plain version."""
    # an M-run ends at its tile's floor; the row-0 D-run < band - W
    check_run_counts(max(T, band - W), entry_dtype, "max(T, band - W)")
    given = not isinstance(lens, step.Lanes)
    if q.device.type == "cpu":
        return gact_traceback_c_plain(q, t, ckpt, lens if given
                                      else lens.lens_tb, T, W, band, scale,
                                      group, mark, iters, entry_dtype)
    B, L = q.shape
    dev = q.device
    if given and (lens.device != dev or lens.shape != (B,)):
        raise ValueError(f"lens {tuple(lens.shape)} on {lens.device}: (B,) "
                         f"on {dev}")
    st, buf = step.gact_setup(lens, gact_runs_cols_c(L, T, W, scale) // 2,
                              entry_dtype)
    return gact_traceback_c_state(q, t, ckpt, st, buf, T, W, band, group,
                                  mark, iters)


def gact_traceback_c_state(q, t, ckpt, st, buf, T: int, W: int, band: int,
                           group: int = 1, mark=None, iters=None):
    """gact_traceback_c on CUDA tensors from its prepared state
    (step.gact_setup): st (3B + 3) int32, each lane's (i, j, done) and the
    shared (ptr, nsat, CTA ticket), and buf (B, 2 n_rows) of pads, int16
    or int32 entries (the walk writes that width), which the walk fills.
    Returns (buf, saturated)."""
    dev = q.device
    with step._on(dev):
        return _gact_walk_run(native_build.load("walk", WALK_FUNCS),
                              _stream(dev), q, t, ckpt, st, buf, T, W, band,
                              group, mark, iters)


def _gact_walk_run(lib, stream, q, t, ckpt, st, buf, T: int, W: int,
                   band: int, group: int, mark, iters):
    """gact_traceback_c_state through `lib`'s lrm_gact_walk on `stream`."""
    B, L = q.shape
    K = L // T
    dev = q.device
    n_rows = buf.shape[1] // 2
    ed = buf.dtype
    for name, x, dtype, shape in (("st", st, torch.int32, (3 * B + 3,)),
                                  ("buf", buf, ed, (B, 2 * n_rows))):
        if (x.dtype != dtype or x.device != dev or x.shape != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {dev}")
    if iters is None:
        iters = torch.empty((K, B), dtype=torch.int32, device=dev)
    elif (iters.dtype != torch.int32 or iters.device != dev
          or tuple(iters.shape) != (K, B) or not iters.is_contiguous()):
        raise ValueError(f"iters must be a contiguous int32 {(K, B)} tensor "
                         f"on {dev}")
    # each lane's pairs, staged until the group's last CTA places them, and
    # where each of its tiles' pairs start
    stage = torch.empty((B, n_rows, 2), dtype=ed, device=dev)
    starts = torch.empty((K, B), dtype=torch.int32, device=dev)

    def walk(k_lo, k_hi, vg, nmg):
        tiles, G = k_hi - k_lo + 1, T // 16
        if (vg.dtype != torch.int32 or nmg.dtype != torch.int32
                or tuple(vg.shape) != (tiles, G, B, band)
                or tuple(nmg.shape) != (tiles, -(-G // 32), B, band)
                or not (vg.is_contiguous() and nmg.is_contiguous())):
            raise ValueError(f"gact_walk takes contiguous int32 words "
                             f"{(tiles, G, B, band)} and bitmaps; got "
                             f"{tuple(vg.shape)}, {tuple(nmg.shape)}")
        err = lib.lrm_gact_walk(vg.data_ptr(), nmg.data_ptr(),
                                st.data_ptr(), iters.data_ptr(),
                                starts.data_ptr(), stage.data_ptr(),
                                buf.data_ptr(), B, T, W, band, k_lo, k_hi,
                                n_rows, ed.itemsize, stream)
        if err != 0:
            raise RuntimeError(f"gact_walk kernel launch failed: error {err}")
        gact_traceback_c.launches += 1

    _for_each_group(q, t, ckpt, T, W, band, group, walk, mark)
    return buf, st[3 * B + 1] >= 2


gact_traceback_c.launches = 0
gact_traceback_c.host_syncs = 0       # the plain version's, on any device


def gact_traceback_c_plain(q, t, ckpt, lens, T: int, W: int, band: int,
                           scale: int = 1, group: int = 1, mark=None,
                           iters=None, entry_dtype=torch.int16):
    """Plain version of gact_traceback_c: eager PyTorch, all lanes in lock
    step, one host sync per iteration of each tile's loop."""
    if q.device.type == "cuda":
        gact_traceback_c_plain.cuda_calls += 1
    # an M-run ends at its tile's floor; the row-0 D-run < band - W
    check_run_counts(max(T, band - W), entry_dtype, "max(T, band - W)")
    B, L = q.shape
    G = T // 16
    dev = q.device
    i64 = torch.int64
    bidx = torch.arange(B, dtype=i64, device=dev)
    n_rows = gact_runs_cols_c(L, T, W, scale) // 2
    tile_bound = W + 4                 # iterations = indels in tile + slack
    i = lens.to(i64)
    j = i.clone()
    done = i <= 0
    buf = torch.full((n_rows, B, 2), OP_PAD, dtype=entry_dtype, device=dev)
    ptr = nsat = syncs = 0
    if iters is not None:
        iters.zero_()

    def walk(k_lo, k_hi, vg, nmg):
        nonlocal i, j, done, ptr, nsat, syncs
        for k in range(k_hi, k_lo - 1, -1):
            lo = k * T
            Vf = vg[k - k_lo].reshape(-1)
            nmf = [w.reshape(-1) for w in nmg[k - k_lo]]

            def word_at(g, d):
                flat = ((g * B + bidx) * band + d).clamp(0,
                                                         G * B * band - 1)
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
                ii = (i - 1 - lo).clamp(0, T - 1)    # row within the tile
                g_cur, r = ii >> 4, ii & 15
                w_cur = word_at(g_cur, d)
                sh = 2 * (15 - r)
                # pairs above i off
                wm_cur = ((w_cur << sh) & _MASK32) >> sh
                in_cur = (wm_cur != 0) & in_tile
                # highest group strictly below g_cur with a non-M pair
                g2 = group_below(nmf,
                                 (bidx * band + d).clamp(0, B * band - 1),
                                 g_cur)
                has_below = (g2 >= 0) & in_tile
                any_nm = active & in_tile & (in_cur | has_below)
                gstar = torch.where(in_cur, g_cur, g2.clamp(min=0))
                wsel = torch.where(in_cur, wm_cur, word_at(gstar, d))
                # 15 - (clz(wsel) >> 1): the word's lowest row with a non-M
                pstar = (15 - ((31 - msb32(wsel)) >> 1)).clamp(min=0)
                # M-run floor: the indel row, else the tile entry (row 0 in
                # tile 0: the walk then owes only the synthetic all-D row)
                floor_row = torch.where(any_nm,
                                        lo + gstar * 16 + pstar + 1,
                                        0 if k == 0 else lo)
                mrun = torch.where(active & in_tile, i - floor_row, 0)
                i2 = i - mrun
                j2 = j - mrun
                op = (wsel >> (2 * pstar)) & 3
                take_e = any_nm & ~((i2 == 0) & (j2 == 0))
                i3 = torch.where(take_e & (op == 1), i2 - 1, i2)
                j3 = torch.where(take_e & (op == 2), j2 - 1, j2)
                drun = torch.where(active & ~any_nm & (i2 == 0),
                                   j2.clamp(min=0), 0)
                j4 = torch.where(drun > 0, 0, j3)
                done = done | ((i3 == 0) & (j4 == 0))
                if iters is not None:
                    iters[k] += active.to(iters.dtype)
                e1 = torch.where(mrun > 0, mrun << 2, OP_PAD)
                e2 = torch.where(take_e, 4 | op,
                                 torch.where(drun > 0, (drun << 2) | 2,
                                             OP_PAD))
                buf[ptr, :, 0] = e1.to(entry_dtype)
                buf[ptr, :, 1] = e2.to(entry_dtype)
                # writes that land on the clamped last row: the first is
                # legitimate, every later one overwrites it for all lanes
                nsat += ptr == n_rows - 1
                ptr = min(ptr + 1, n_rows - 1)
                i, j = i3, j4
                it += 1

    _for_each_group(q, t, ckpt, T, W, band, group, walk, mark)
    gact_traceback_c.host_syncs += syncs
    return (buf.permute(1, 0, 2).reshape(B, -1),
            torch.tensor(nsat >= 2, device=dev))


gact_traceback_c_plain.cuda_calls = 0
