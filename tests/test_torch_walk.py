"""The CIGAR walks' CUDA kernels (csrc/walk.cu) on the CPU, through scalar
per-lane models of their loops, and on the card against the plain walks.

The models below are written as the CUDA code is written, lane by lane in
Python integers: the first walk_c_kernel's independent lanes, each to done
or to its iteration bound, with the bitmap scan that starts at g_cur's own
word and stops at the first hit; walk_c_kernel as it is written now, a
warp a lane over a ring of its columns (each load's window, group and
readiness checked where the walk reads it), the clamps of the plain walk
past row L and the whole row written at the end; the lock-step gact walk
whose semantics gact_walk_kernel keeps (one shared write pointer, a
per-tile "any lane alive" loop, the clamped last row that every lane's
pair overwrites), and
gact_walk_kernel as it is written: a lane at its own pace with its
iterations a tile and a staging row, then the group's last CTA's maxima,
prefix, copy and clamped row.  Each model is held equal to the port's
plain walk and to JAX's device_traceback_c / gact_traceback_c: ragged
lengths, two or more bitmap words, int32 entries, dead lanes, random
words for the clamps and the tile bound, and a forced saturation at
scale 1.  The wrappers' dispatch on a CPU tensor reaches the plain walk.

The card tests import no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_walk.py
"""

import numpy as np
import pytest
import torch

from longreadmapper_tpu_torch.ops import gact as tg
from longreadmapper_tpu_torch.ops import traceback as ttb

torch.set_num_threads(1)

M32 = 0xFFFFFFFF


# ----------------------------------------------------------------- models

def _clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def _clz(x):
    return 32 - x.bit_length()


def _below_mask(g_cur, w):
    lim = _clamp(g_cur - (w << 5), 0, 32)
    return M32 if lim >= 32 else (1 << lim) - 1


def _group_below(bm, nbm, g_cur):
    """walk.cu::group_below: from min(nbm-1, g_cur >> 5) down, the first
    non-zero masked bitmap word gives the group.  bm(w): the lane's
    bitmap word w as a uint32 Python int."""
    w = min(nbm - 1, g_cur >> 5)
    bwk = bm(w) & _below_mask(g_cur, w)
    while bwk == 0 and w > 0:
        w -= 1
        bwk = bm(w) & _below_mask(g_cur, w)
    return (w << 5) + bwk.bit_length() - 1 if bwk else -1


def _word(v, g, b, d, B, band):
    flat = _clamp((g * B + b) * band + d, 0, len(v) - 1)
    return v[flat]


def _entry(count, op, bits):
    x = ((count << 2) | op) & ((1 << bits) - 1)
    return x - (1 << bits) if x >> (bits - 1) else x


def _u32(a):
    return [int(x) & M32 for x in np.asarray(a).reshape(-1)]


def model_walk_c(vdirs, nm, lens, L, W, bits=16):
    """walk_c_kernel, one lane at a time.  vdirs (G, B, band), nm (nbm,
    B, band) int32 arrays; returns runs (B, 2 * (W + 6))."""
    G, B, band = vdirs.shape
    v = _u32(vdirs)
    nmw = [_u32(nm[w]) for w in range(nm.shape[0])]
    n_iter = ttb.traceback_c_iters(L, W)
    runs = np.full((B, 2 * n_iter), 3, np.int64)
    for b in range(B):
        i = j = int(lens[b])
        done = i <= 0
        it = 0
        while it < n_iter and not done:
            d = _clamp(j - i + W, 0, band - 1)
            ii = max(i - 1, 0)
            g_cur, r = ii >> 4, ii & 15
            sh = 2 * (15 - r)
            wm_cur = ((_word(v, g_cur, b, d, B, band) << sh) & M32) >> sh
            in_cur = wm_cur != 0
            bmidx = _clamp(b * band + d, 0, B * band - 1)
            g2 = -1 if in_cur else _group_below(lambda w: nmw[w][bmidx],
                                                len(nmw), g_cur)
            any_nm = i > 0 and (in_cur or g2 >= 0)
            gstar = g_cur if in_cur else max(g2, 0)
            wsel = (wm_cur if in_cur else
                    _word(v, gstar, b, d, B, band) if any_nm else 0)
            pstar = 15 - (_clz(wsel) >> 1)
            re = gstar * 16 + pstar + 1 if any_nm else 0
            mrun = i - re
            i2, j2 = i - mrun, j - mrun
            op = (wsel >> (2 * max(pstar, 0))) & 3
            i3 = i2 - 1 if any_nm and op == 1 else i2
            j3 = j2 - 1 if any_nm and op == 2 else j2
            drun = max(j2, 0) if not any_nm and i2 == 0 else 0
            j4 = 0 if drun > 0 else j3
            done = i3 == 0 and j4 == 0
            runs[b, 2 * it] = _entry(mrun, 0, bits) if mrun > 0 else 3
            runs[b, 2 * it + 1] = (_entry(1, op, bits) if any_nm else
                                   _entry(drun, 2, bits) if drun > 0 else 3)
            i, j = i3, j4
            it += 1
    return runs


def _resident_step(word, bm, nbm, i, j, G, seen):
    """walk.cu::resident_step on a column view (word(g), bm(w)): (i, j,
    e1, e2) with the entries as 32-bit (count << 2) | op or 3; seen["bit
    past G"] counts the bitmap bits taken at groups >= G."""
    any_nm, gstar, wsel = False, 0, 0
    if i > 0:
        ii = i - 1
        g_cur, sh = ii >> 4, 2 * (15 - (ii & 15))
        wm = ((word(g_cur) << sh) & M32) >> sh
        if wm:
            any_nm, gstar, wsel = True, g_cur, wm
        else:
            g2 = _group_below(bm, nbm, g_cur)
            if g2 >= 0:
                seen["bit past G"] += g2 >= G
                any_nm, gstar, wsel = True, g2, word(g2)
    praw = 15 - (_clz(wsel) >> 1)
    pstar = max(praw, 0)
    mrun = i - (gstar * 16 + praw + 1 if any_nm else 0) if i > 0 else 0
    i2, j2 = i - mrun, j - mrun
    op = (wsel >> (2 * pstar)) & 3
    drun = max(j2, 0) if not any_nm and i2 == 0 else 0
    e1 = mrun << 2 if mrun > 0 else 3
    e2 = 4 | op if any_nm else (drun << 2) | 2 if drun > 0 else 3
    i3 = i2 - 1 if any_nm and op == 1 else i2
    j3 = j2 - 1 if any_nm and op == 2 else j2
    return i3, 0 if drun > 0 else j3, e1, e2


def walk_c_window(G, k_groups=8):
    """lrm_walk_c's window K: k_groups groups, more to fill the warp's last
    round of copies with the bitmap words, at most G."""
    nbm = -(-G // 32)
    return min(G, max(k_groups, -(-(nbm + k_groups) // 32) * 32 - nbm))


class _Ring:
    """A lane's ring of `size` column slots filled by cp.async groups, as
    walk_c_kernel keeps it: load() records a slot's column, window start,
    groups, bitmap words and commit group, and skips a slot whose last
    load is still in flight (which the ring's size makes the same column);
    column(d) gives the step's view of column d, reading a slot only where
    the kernel's last wait has retired its load."""

    def __init__(self, size, v, nmw, b, B, band, G, tail, seen):
        self.size, self.v, self.nmw = size, v, nmw
        self.b, self.B, self.band, self.G = b, B, band, G
        self.tail, self.seen = tail, seen
        self.slots = [None] * size
        self.committed = self.retired = 0

    def load(self, x, lo, gn, wn):
        k = x & (self.size - 1)
        old = self.slots[k]
        if old is not None and old[4] >= self.retired:
            assert old[0] == x, "another column's load still in flight"
            self.seen["kept"] += 1
            return
        self.slots[k] = (x, lo, gn, wn, self.committed)

    def commit(self):
        self.committed += 1

    def wait(self, ahead):                     # cp_wait<ahead>
        self.retired = self.committed - ahead

    def column(self, d):
        x, lo, gn, wn, grp = self.slots[d & (self.size - 1)]
        assert x == d and grp < self.retired, (x, d, grp, self.retired)
        at = self.b * self.band + d

        def word(g):
            if g >= self.G:
                self.seen["tail"] += 1
                return self.tail
            if g < lo:
                self.seen["below"] += 1         # from device memory
            else:
                assert g - lo < gn, (g, lo, gn)
            return self.v[g * self.B * self.band + at]

        def bm(w):
            assert w < wn, (w, wn)
            return self.nmw[w][at]
        return word, bm


def model_walk_c_warp(vdirs, nm, lens, L, W, bits=16, ahead=1, ring=4,
                      k_groups=8, seen=None):
    """walk_c_kernel as it is written: a warp a lane over the ring of its
    columns d +- ahead, each a window of walk_c_window(G, k_groups) groups
    from the lane's group down and the bitmap words over them, loaded
    `ahead` iterations before the walk can reach them; the resident_step
    iteration, groups below a window from device memory; entries staged
    and the lane's whole row written at the end.  Returns runs (B, 2 * (W
    + 6)); `seen` counts the reads of the tensor's last word (lanes past
    row L), of groups below a window, the loads kept in flight and the
    bitmap bits taken past G."""
    G, B, band = vdirs.shape
    nbm = nm.shape[0]
    K = walk_c_window(G, k_groups)
    v = _u32(vdirs)
    nmw = [_u32(nm[w]) for w in range(nbm)]
    n_iter = ttb.traceback_c_iters(L, W)
    if seen is None:
        seen = {}
    for k in ("tail", "below", "kept", "bit past G"):
        seen.setdefault(k, 0)
    runs = np.full((B, 2 * n_iter), -99, np.int64)   # every element written
    for b in range(B):
        i = j = int(lens[b])
        done = i <= 0
        tail = v[-1] if not done and ((i - 1) >> 4) >= G else 0
        r = _Ring(ring, v, nmw, b, B, band, G, tail, seen)

        def load(x):
            g_top = (i - 1) >> 4
            g_hi = min(G - 1, g_top)
            lo = max(0, g_hi - K + 1)
            r.load(x, lo, g_hi - lo + 1, min(nbm, (g_top >> 5) + 1))

        d = _clamp(W, 0, band - 1)
        if not done:
            for s in range(ahead + 1):
                if d - s >= 0:
                    load(d - s)
                if s > 0 and d + s < band:
                    load(d + s)
                r.commit()
        stage = []
        while len(stage) < 2 * n_iter and not done:
            in_tile = i > 0
            if in_tile:
                r.wait(ahead)
            word, bm = r.column(d) if in_tile else (None, None)
            i, j, e1, e2 = _resident_step(word, bm, nbm, i, j, G, seen)
            stage += [_entry(e >> 2, e & 3, bits) for e in (e1, e2)]
            done = i == 0 and j == 0
            if in_tile:
                d2 = _clamp(j - i + W, 0, band - 1)
                x = d2 + ahead if d2 > d else d2 - ahead
                if d2 != d and not done and i > 0 and 0 <= x < band:
                    load(x)
                r.commit()
                d = d2
        runs[b] = stage + [3] * (2 * n_iter - len(stage))
    return runs


def _gact_step(v, nmw, b, B, band, T, W, k, i, j):
    """One iteration of an alive lane b at (i, j) in tile k (walk.cu's
    column_step): (i, j, e1, e2).  v (G*B*band) and nmw (nbm lists of
    B*band) hold the tile's words as uint32 Python ints."""
    lo = k * T
    in_tile = i > lo
    any_nm, gstar, wsel = False, 0, 0
    if in_tile:
        d = _clamp(j - i + W, 0, band - 1)
        ii = _clamp(i - 1 - lo, 0, T - 1)
        g_cur, r = ii >> 4, ii & 15
        sh = 2 * (15 - r)
        wm = ((_word(v, g_cur, b, d, B, band) << sh) & M32) >> sh
        bmidx = _clamp(b * band + d, 0, B * band - 1)
        g2 = -1 if wm else _group_below(lambda w: nmw[w][bmidx], len(nmw),
                                        g_cur)
        any_nm = wm != 0 or g2 >= 0
        gstar = g_cur if wm else max(g2, 0)
        wsel = (wm if wm else
                _word(v, gstar, b, d, B, band) if any_nm else 0)
    pstar = max(15 - (_clz(wsel) >> 1), 0)
    floor_row = (lo + gstar * 16 + pstar + 1 if any_nm
                 else (0 if k == 0 else lo))
    mrun = i - floor_row if in_tile else 0
    i2, j2 = i - mrun, j - mrun
    op = (wsel >> (2 * pstar)) & 3
    take_e = any_nm and not (i2 == 0 and j2 == 0)
    i3 = i2 - 1 if take_e and op == 1 else i2
    j3 = j2 - 1 if take_e and op == 2 else j2
    drun = max(j2, 0) if not any_nm and i2 == 0 else 0
    e1 = _entry(mrun, 0, 16) if mrun > 0 else 3
    e2 = (_entry(1, op, 16) if take_e else
          _entry(drun, 2, 16) if drun > 0 else 3)
    return i3, 0 if drun > 0 else j3, e1, e2


def _alive(done, i, j, k, lo):
    return not done and (i > lo or (k == 0 and j > 0))


def _gact_groups(q, t, ckpt, T, W, band, group, walk):
    """walk(k_lo, k_hi, words, bitmaps) over ops/gact._for_each_group's
    groups (the plain tile groups on the CPU), each tile's words and
    bitmap words as uint32 Python ints."""
    def on_group(k_lo, k_hi, vg, nmg):
        vg, nmg = vg.cpu().numpy(), nmg.cpu().numpy()
        walk(k_lo, k_hi, [_u32(x) for x in vg],
             [[_u32(w) for w in x] for x in nmg])
    tg._for_each_group(torch.as_tensor(q), torch.as_tensor(t), ckpt, T, W,
                       band, group, on_group, None)


def model_gact_walk(q, t, ckpt, lens, T, W, band, scale=1, group=1):
    """The lock-step walk that gact_walk_kernel reproduces (the plain
    walk's semantics): one state for all lanes, one shared write pointer,
    each tile's loop until no lane is alive.  Returns (runs (B,
    gact_runs_cols_c), saturated)."""
    B, L = q.shape
    n_rows = tg.gact_runs_cols_c(L, T, W, scale) // 2
    buf = np.full((B, n_rows, 2), 3, np.int64)
    st = dict(i=[int(x) for x in lens], j=[int(x) for x in lens],
              done=[int(x) <= 0 for x in lens], ptr=0, nsat=0)

    def walk(k_lo, k_hi, vs, nms):
        for k in range(k_hi, k_lo - 1, -1):
            v, nmw = vs[k - k_lo], nms[k - k_lo]
            lo = k * T
            i, j, done = st["i"], st["j"], st["done"]
            for _ in range(W + 4):
                if not any(_alive(done[b], i[b], j[b], k, lo)
                           for b in range(B)):
                    break
                ptr = st["ptr"]
                for b in range(B):
                    e1 = e2 = 3
                    if _alive(done[b], i[b], j[b], k, lo):
                        i[b], j[b], e1, e2 = _gact_step(v, nmw, b, B, band,
                                                        T, W, k, i[b], j[b])
                    if i[b] == 0 and j[b] == 0:
                        done[b] = True
                    # every lane's pair, pads included, into the shared row
                    buf[b, ptr] = (e1, e2)
                st["nsat"] += ptr == n_rows - 1
                st["ptr"] = min(ptr + 1, n_rows - 1)

    _gact_groups(q, t, ckpt, T, W, band, group, walk)
    return buf.reshape(B, -1).astype(np.int16), st["nsat"] >= 2


def model_gact_walk_lanes(q, t, ckpt, lens, T, W, band, scale=1, group=1):
    """gact_walk_kernel as it is written: in each group's launch every lane
    walks the group's tiles at its own pace (while alive, at most W + 4
    iterations a tile), counting its iterations a tile (cnt) and staging
    its pairs in a row of its own (only the last past n_rows - 1); then
    the group's last CTA takes each tile's block iterations as the maximum
    over lanes, their prefix from the carried ptr + nsat, copies each
    lane's pairs to the rows below the clamped one, writes the clamped
    row from the group's last block iteration and carries ptr and nsat.
    Returns (runs, saturated, cnt (L/T, B))."""
    B, L = q.shape
    n_rows = tg.gact_runs_cols_c(L, T, W, scale) // 2
    clamp = n_rows - 1
    buf = np.full((B, n_rows, 2), 3, np.int64)
    cnt = np.zeros((L // T, B), np.int32)
    off = np.zeros((L // T, B), np.int64)
    lanes = [[int(x), int(x), int(x) <= 0] for x in lens]
    st = dict(ptr=0, nsat=0)

    def walk(k_lo, k_hi, vs, nms):
        stage = [[None] * n_rows for _ in range(B)]
        for b in range(B):                     # a warp a lane
            i, j, done = lanes[b]
            a = 0
            for k in range(k_hi, k_lo - 1, -1):
                off[k, b] = a
                n = 0
                while n < W + 4 and _alive(done, i, j, k, k * T):
                    i, j, e1, e2 = _gact_step(vs[k - k_lo], nms[k - k_lo],
                                              b, B, band, T, W, k, i, j)
                    stage[b][min(a, clamp)] = (e1, e2)
                    a += 1
                    n += 1
                    done = i == 0 and j == 0
                cnt[k, b] = n
            lanes[b] = [i, j, done]
        # the group's last CTA
        ks = range(k_hi, k_lo - 1, -1)
        base, g = {}, st["ptr"] + st["nsat"]
        for k in ks:
            base[k] = g
            g += int(cnt[k].max())
        for k in ks:
            for b in range(B):
                for it in range(min(int(cnt[k, b]), clamp - base[k])):
                    buf[b, base[k] + it] = stage[b][off[k, b] + it]
        if g > clamp and g > base[k_hi]:
            k = min(k for k in ks if cnt[k].max() > 0)
            for b in range(B):
                last = min(off[k, b] + cnt[k, b] - 1, clamp)
                buf[b, clamp] = (stage[b][last] if cnt[k, b] == cnt[k].max()
                                 else (3, 3))
        st["ptr"], st["nsat"] = min(g, clamp), max(0, g - clamp)

    _gact_groups(q, t, ckpt, T, W, band, group, walk)
    return buf.reshape(B, -1).astype(np.int16), st["nsat"] >= 2, cnt


def _random_groups(monkeypatch, seed):
    """Replace the tiles' direction pass with random words and bitmaps (a
    group's the same on every call), so lanes wander over the band and
    run into the tile bound; returns a dict that counts the calls."""
    seen = {"calls": 0}

    def dirs(q, t, W, band, ckpt, T, k0, tiles):
        seen["calls"] += 1
        rng = np.random.default_rng([seed, k0])
        B, G = q.shape[0], T // 16
        v = rng.integers(-2**31, 2**31, (tiles, G, B, band), dtype=np.int64)
        v[rng.random(v.shape) < 0.7] = 0
        nm = rng.integers(-2**31, 2**31, (tiles, -(-G // 32), B, band),
                          dtype=np.int64)
        return (torch.from_numpy(v.astype(np.int32)).to(q.device), None,
                torch.from_numpy(nm.astype(np.int32)).to(q.device))

    monkeypatch.setattr(tg, "banded_nw_dirs_tiles", dirs)
    return seen


# ------------------------------------------------------------------ data

def _mutate(rng, q, n_sub, n_ind):
    t = list(q)
    for _ in range(n_sub):
        p = rng.integers(0, len(t))
        t[p] = (t[p] + 1 + rng.integers(0, 3)) % 4
    for _ in range(n_ind):
        p = int(rng.integers(1, len(t) - 1))
        if rng.random() < 0.5:
            del t[p]
        else:
            t.insert(p, int(rng.integers(0, 4)))
    return t


def _reads(seed, B, L, W, max_sub=20):
    """Ragged reads with substitutions and up to W/2 indels; lane 0 dead."""
    rng = np.random.default_rng(seed)
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        qb = rng.integers(0, 4, n)
        tb = _mutate(rng, list(qb), int(rng.integers(0, max_sub)),
                     int(rng.integers(0, W // 2)))
        tb = (tb + [5] * L)[:L]
        q[b, :n] = qb
        t[b, :len(tb)] = tb
        lens[b] = n
    lens[0] = 0
    return q, t, lens


def _dirs(q, t, lens, W, band):
    """The plain pass's words and bitmap, and lens with over-W lanes dead."""
    from longreadmapper_tpu_torch.ops.wavefront import banded_nw_dirs_v
    v, wc, nm = banded_nw_dirs_v(torch.from_numpy(q), torch.from_numpy(t),
                                 W, band)
    ed = wc[torch.from_numpy(lens).long(), torch.arange(q.shape[0])]
    return v, nm, torch.where(ed <= W, torch.from_numpy(lens), 0)


def _jax_walk_c(v, nm, lens, L, W, wide):
    import jax.numpy as jnp
    from longreadmapper_tpu.ops.traceback import device_traceback_c
    return np.asarray(device_traceback_c(
        jnp.asarray(v.numpy()), jnp.asarray(lens.numpy()), L, W,
        nm=jnp.asarray(nm.numpy()),
        entry_dtype=jnp.int32 if wide else jnp.int16))


# ------------------------------------------------------------- W1, CPU

@pytest.mark.parametrize("L,W,band,B,wide,seed", [
    (256, 24, 128, 12, False, 0),      # ragged, one bitmap word
    (1024, 40, 128, 6, False, 1),      # 64 groups: two bitmap words
    (2048, 60, 256, 5, True, 2),       # four words, int32 entries
])
def test_walk_c_model_matches_plain_and_jax(L, W, band, B, wide, seed):
    q, t, lens = _reads(seed, B, L, W)
    v, nm, lt = _dirs(q, t, lens, W, band)
    dt = torch.int32 if wide else torch.int16
    plain = ttb.device_traceback_c_plain(v, lt, L, W, nm, dt).numpy()
    model = model_walk_c(v.numpy(), nm.numpy(), lt.numpy(), L, W,
                         32 if wide else 16)
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(plain, _jax_walk_c(v, nm, lt, L, W, wide))
    assert (lt == 0).any() and (lt > 0).sum() >= B // 2
    assert ((plain & 3 == 1) | (plain & 3 == 2)).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_walk_c_model_clamps_on_random_words(seed):
    """Random words and bitmaps that agree with nothing (lanes run to the
    iteration bound), lens past L and negative: every clamp, the shift
    by 32 of the bitmap mask and clz(0), in both entry widths."""
    rng = np.random.default_rng(300 + seed)
    G, B, band, W = [45, 70, 9, 33][seed], 6, 128, 30
    L = 16 * G
    v = rng.integers(-2**31, 2**31, (G, B, band), dtype=np.int64)
    if seed % 2:
        v[rng.random(v.shape) < 0.8] = 0
    v = torch.from_numpy(v.astype(np.int32))
    nm = torch.from_numpy(rng.integers(
        -2**31, 2**31, (-(-G // 32), B, band), dtype=np.int64).astype(
            np.int32))
    lens = torch.from_numpy(np.array([L, L + 40, -3, 0, 17, L // 2],
                                     np.int32))
    for wide in (False, True):
        plain = ttb.device_traceback_c_plain(
            v, lens, L, W, nm, torch.int32 if wide else torch.int16).numpy()
        model = model_walk_c(v.numpy(), nm.numpy(), lens.numpy(), L, W,
                             32 if wide else 16)
        np.testing.assert_array_equal(model, plain)
        np.testing.assert_array_equal(plain,
                                      _jax_walk_c(v, nm, lens, L, W, wide))


WALK_C_CASES = [
    (256, 24, 128, 12, False, 0),      # ragged, one bitmap word
    (1024, 40, 128, 6, False, 1),      # 64 groups: two bitmap words
    (2048, 60, 256, 5, True, 2),       # four words, int32 entries
    (800, 40, 128, 7, False, 3),       # G 50, not a multiple of 32
]


@pytest.mark.parametrize("L,W,band,B,wide,seed", WALK_C_CASES)
@pytest.mark.parametrize("ahead,ring,k_groups", [(1, 4, 8), (2, 8, 40)])
def test_walk_c_warp_model_matches_plain_and_jax(L, W, band, B, wide, seed,
                                                 ahead, ring, k_groups):
    """The warp-a-lane walk over its ring of columns (the kernel's columns
    d +- 1 with windows of at least 8 groups, and d +- 2 with 40) equals
    the plain walk and JAX's on real words."""
    q, t, lens = _reads(seed, B, L, W)
    v, nm, lt = _dirs(q, t, lens, W, band)
    dt = torch.int32 if wide else torch.int16
    plain = ttb.device_traceback_c_plain(v, lt, L, W, nm, dt).numpy()
    seen = {}
    model = model_walk_c_warp(v.numpy(), nm.numpy(), lt.numpy(), L, W,
                              32 if wide else 16, ahead, ring, k_groups,
                              seen)
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(plain, _jax_walk_c(v, nm, lt, L, W, wide))
    if ahead > 1:
        assert seen["kept"] > 0       # a column back while its load flies
    assert ((plain & 3 == 1) | (plain & 3 == 2)).any()


def _random_words(rng, G, B, band, sparse):
    v = rng.integers(-2**31, 2**31, (G, B, band), dtype=np.int64)
    if sparse:
        v[rng.random(v.shape) < 0.8] = 0
    nm = rng.integers(-2**31, 2**31, (-(-G // 32), B, band), dtype=np.int64)
    return (torch.from_numpy(v.astype(np.int32)),
            torch.from_numpy(nm.astype(np.int32)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_walk_c_warp_model_clamps_on_random_words(seed):
    """test_walk_c_model_clamps_on_random_words's words and lens for the
    warp-a-lane walk: lanes past L read the tensor's last word for their
    current group and for bitmap bits at groups >= G."""
    rng = np.random.default_rng(300 + seed)
    G, B, band, W = [45, 70, 9, 33][seed], 6, 128, 30
    L = 16 * G
    v, nm = _random_words(rng, G, B, band, seed % 2)
    lens = torch.from_numpy(np.array([L, L + 40, -3, 0, 17, L // 2],
                                     np.int32))
    seen = {}
    for wide in (False, True):
        plain = ttb.device_traceback_c_plain(
            v, lens, L, W, nm, torch.int32 if wide else torch.int16).numpy()
        model = model_walk_c_warp(v.numpy(), nm.numpy(), lens.numpy(), L, W,
                                  32 if wide else 16, seen=seen)
        np.testing.assert_array_equal(model, plain)
        np.testing.assert_array_equal(plain,
                                      _jax_walk_c(v, nm, lens, L, W, wide))
    assert seen["tail"] > 0


@pytest.mark.parametrize("case", ["lens past L", "bit past G",
                                  "G not a multiple of 32",
                                  "group below the window"])
def test_walk_c_warp_model_clamp_paths(case):
    """One crafted case a path of the resident walk: a lane that starts
    past row L (its current group >= G reads the tensor's last word), a
    bitmap bit at a group >= G that the scan from such a row takes (the
    last word again, here 0: the M-run ends at 16 gstar), real words at G
    = 50 with lanes 300 rows past L, and an M-run from row 1000 to an
    insertion near row 40, whose word lies below the slot's window."""
    rng = np.random.default_rng(17)
    B, band, W = 4, 64, 12
    seen = {}
    if case == "group below the window":
        L = 1024
        q = rng.integers(0, 4, (B, L)).astype(np.int8)
        t = np.concatenate([q[:, :40], np.full((B, 1), 2, np.int8),
                            q[:, 40:-1]], axis=1)
        v, nm, lt = _dirs(q, t, np.full(B, L, np.int32), W, band)
        lt[1] = 0
    elif case == "G not a multiple of 32":
        L = 800
        q, t, lens = _reads(5, B, L, W)
        v, nm, lt = _dirs(q, t, lens, W, band)
        lt = torch.where(lt > 0, lt + 300, lt)
    else:
        G = 40 if case == "bit past G" else 20
        L = 16 * G
        v, nm = _random_words(rng, G, B, band, True)
        lt = torch.tensor([L + 37, L + 16 * 7 + 3, 5, 0], dtype=torch.int32)
        if case == "bit past G":
            v[-1, -1, -1] = 0                    # the tensor's last word
            v[:, :2] = 0                         # no non-M pair in lanes 0-1
            nm[:, :2] = 0
            nm[1, :2, :] = 1 << (45 - 32)        # only group 45's bit
    for dt, bits in ((torch.int16, 16), (torch.int32, 32)):
        plain = ttb.device_traceback_c_plain(v, lt, L, W, nm, dt).numpy()
        model = model_walk_c_warp(v.numpy(), nm.numpy(), lt.numpy(), L, W,
                                  bits, seen=seen)
        np.testing.assert_array_equal(model, plain)
        np.testing.assert_array_equal(plain, _jax_walk_c(v, nm, lt, L, W,
                                                         bits == 32))
        np.testing.assert_array_equal(
            model_walk_c(v.numpy(), nm.numpy(), lt.numpy(), L, W, bits),
            plain)
    if case == "group below the window":
        assert seen["below"] > 0 and int((lt > 0).sum()) == B - 1
    else:
        assert seen["tail"] > 0
    if case == "bit past G":
        assert seen["bit past G"] > 0


def test_group_below_early_exit_equals_full_scan():
    """The kernel's scan from g_cur's word down to the first hit gives the
    plain walk's full scan's group, on bitmaps with few bits set."""
    rng = np.random.default_rng(11)
    nbm, n = 4, 400
    nm = rng.integers(0, 2**32, (nbm, n), dtype=np.int64)
    nm &= rng.integers(0, 2**32, (nbm, n), dtype=np.int64)
    nm &= rng.integers(0, 2**32, (nbm, n), dtype=np.int64)
    nm[:, ::5] = 0
    g_cur = rng.integers(0, 32 * nbm + 40, n)
    nmf = [torch.from_numpy(nm[w].astype(np.uint32).view(np.int32))
           for w in range(nbm)]
    want = ttb.group_below(nmf, torch.arange(n), torch.from_numpy(g_cur))
    words = [[int(x) for x in nm[w]] for w in range(nbm)]
    got = [_group_below(lambda w: words[w][k], nbm, int(g_cur[k]))
           for k in range(n)]
    assert got == want.tolist()
    assert (want >= 0).any() and (want < 0).any()


# ------------------------------------------------------------- W2, CPU

def _gact_case(kind, seed=0):
    if kind == "weave":
        from test_torch_gact import _weave
        return _weave(4, 2048, 128, 24, seed=11), 128, 32, 128
    from test_torch_gact import _pair
    B, L = (7, 512) if kind == "pair" else (5, 1024)
    q, t, lens = _pair(seed, B, L)
    lens[1] = 0                                   # a dead lane
    lens[-1] = L - 40                             # a shorter read
    return (q, t, lens), 64, 30, 128


@pytest.mark.parametrize("kind,scale,group", [
    ("pair", 1, 1), ("pair", 1, 3), ("long", 1, 16),
    ("weave", 1, 3),                   # saturates at scale 1
    ("weave", 4, 16)])
def test_gact_walk_model_matches_plain_and_jax(kind, scale, group):
    import jax.numpy as jnp
    from longreadmapper_tpu.ops import gact as jg
    (q, t, lens), T, W, band = _gact_case(kind, seed=5)
    tq, tt, tl = (torch.from_numpy(a) for a in (q, t, lens))
    ckpt, _ = tg.gact_forward(tq, tt, T, W, band)
    runs, sat = tg.gact_traceback_c(tq, tt, ckpt, tl, T, W, band, scale,
                                    group)
    assert sat.dtype == torch.bool and sat.dim() == 0
    m_runs, m_sat = model_gact_walk(q, t, ckpt, lens, T, W, band, scale,
                                    group)
    np.testing.assert_array_equal(m_runs, runs.numpy())
    assert m_sat == bool(sat)
    ck_w, _ = jg.gact_forward(jnp.asarray(q), jnp.asarray(t), T, W, band)
    runs_w, sat_w = jg.gact_traceback_c(jnp.asarray(q), jnp.asarray(t), ck_w,
                                        jnp.asarray(lens), T, W, band,
                                        scale=scale)
    np.testing.assert_array_equal(runs.numpy(), np.asarray(runs_w))
    assert bool(sat) == bool(sat_w)
    if kind == "weave" and scale == 1:
        assert m_sat                     # the forced saturation, flagged
        n_rows = tg.gact_runs_cols_c(2048, T, W, 1) // 2
        assert n_rows < (2048 // T) * 24  # fewer rows than the indels


def test_gact_walk_model_clamps_on_perturbed_checkpoints():
    """Checkpoint rows off by a few give words whose paths wander out of
    the band, with lens past L and negative: the model equals the plain
    walk at both scales."""
    from test_torch_gact import _pair
    rng = np.random.default_rng(7)
    B, L, T, W, band = 9, 512, 64, 20, 128
    q, t, _ = _pair(3, B, L)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ckpt, _ = tg.gact_forward(tq, tt, T, W, band)
    ckpt = ckpt + torch.from_numpy(rng.integers(-3, 4, ckpt.shape).astype(
        np.int32))
    lens = np.array([L, L + 20, -2, 0, 300, 17, L - 1, 64, 65], np.int32)
    for scale in (1, 4):
        runs, sat = tg.gact_traceback_c_plain(tq, tt, ckpt,
                                              torch.from_numpy(lens), T, W,
                                              band, scale, 3)
        m_runs, m_sat = model_gact_walk(q, t, ckpt, lens, T, W, band, scale,
                                        3)
        np.testing.assert_array_equal(m_runs, runs.numpy())
        assert m_sat == bool(sat)


@pytest.mark.parametrize("kind,scale,group", [
    ("pair", 1, 1), ("pair", 1, 3), ("long", 1, 16),
    ("weave", 1, 3),                   # saturates at scale 1
    ("weave", 4, 16)])
def test_gact_walk_lanes_model_matches_plain_and_jax(kind, scale, group):
    """The decoupled walk (a lane at its own pace, the rows rebuilt by the
    group's last CTA) equals the lock-step plain walk and JAX's, runs,
    saturated flag and each lane's iterations a tile."""
    import jax.numpy as jnp
    from longreadmapper_tpu.ops import gact as jg
    (q, t, lens), T, W, band = _gact_case(kind, seed=5)
    tq, tt, tl = (torch.from_numpy(a) for a in (q, t, lens))
    ckpt, _ = tg.gact_forward(tq, tt, T, W, band)
    iters = torch.zeros((q.shape[1] // T, q.shape[0]), dtype=torch.int32)
    runs, sat = tg.gact_traceback_c_plain(tq, tt, ckpt, tl, T, W, band,
                                          scale, group, iters=iters)
    m_runs, m_sat, m_cnt = model_gact_walk_lanes(q, t, ckpt, lens, T, W,
                                                 band, scale, group)
    np.testing.assert_array_equal(m_runs, runs.numpy())
    np.testing.assert_array_equal(m_cnt, iters.numpy())
    assert m_sat == bool(sat)
    ck_w, _ = jg.gact_forward(jnp.asarray(q), jnp.asarray(t), T, W, band)
    runs_w, sat_w = jg.gact_traceback_c(jnp.asarray(q), jnp.asarray(t), ck_w,
                                        jnp.asarray(lens), T, W, band,
                                        scale=scale)
    np.testing.assert_array_equal(m_runs, np.asarray(runs_w))
    assert m_sat == bool(sat_w)
    if kind == "weave" and scale == 1:
        assert m_sat                     # the forced saturation, flagged
    if kind != "weave":
        # the lanes' own paces: the longest lane makes fewer iterations
        # than the tiles' block iterations the lock-step walk pays
        assert m_cnt.sum(axis=0).max() < m_cnt.max(axis=1).sum()


def test_gact_walk_lanes_model_clamps_on_perturbed_checkpoints():
    """Perturbed checkpoints (paths out of the band), lens past L, dead
    lanes (0 and negative): the decoupled walk equals the plain walk at
    both scales."""
    from test_torch_gact import _pair
    rng = np.random.default_rng(7)
    B, L, T, W, band = 9, 512, 64, 20, 128
    q, t, _ = _pair(3, B, L)
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ckpt, _ = tg.gact_forward(tq, tt, T, W, band)
    ckpt = ckpt + torch.from_numpy(rng.integers(-3, 4, ckpt.shape).astype(
        np.int32))
    lens = np.array([L, L + 20, -2, 0, 300, 17, L - 1, 64, 65], np.int32)
    for scale in (1, 4):
        runs, sat = tg.gact_traceback_c_plain(tq, tt, ckpt,
                                              torch.from_numpy(lens), T, W,
                                              band, scale, 3)
        m_runs, m_sat, m_cnt = model_gact_walk_lanes(q, t, ckpt, lens, T, W,
                                                     band, scale, 3)
        np.testing.assert_array_equal(m_runs, runs.numpy())
        assert m_sat == bool(sat)
        assert (m_cnt[:, 2:4] == 0).all()          # the dead lanes


@pytest.mark.parametrize("seed,scale", [(0, 1), (1, 1), (2, 4)])
def test_gact_walk_lanes_model_on_random_words(monkeypatch, seed, scale):
    """Random words and bitmaps: lanes that the tile bound stops, lanes at
    the band's edges, a buffer that saturates at scale 1; the decoupled
    walk equals the lock-step model and the plain walk, and with them
    saturation."""
    B, L, T, W, band = 6, 512, 64, 12, 48
    seen = _random_groups(monkeypatch, seed)
    q = np.zeros((B, L), np.int8)
    lens = np.array([L, L - 5, 0, 200, L + 30, 70], np.int32)
    ckpt = torch.zeros((L // T + 1, B, band), dtype=torch.int32)
    tl = torch.from_numpy(lens)
    iters = torch.zeros((L // T, B), dtype=torch.int32)
    runs, sat = tg.gact_traceback_c_plain(torch.from_numpy(q),
                                          torch.from_numpy(q), ckpt, tl, T,
                                          W, band, scale, 3, iters=iters)
    m_runs, m_sat, m_cnt = model_gact_walk_lanes(q, q, ckpt, lens, T, W,
                                                 band, scale, 3)
    l_runs, l_sat = model_gact_walk(q, q, ckpt, lens, T, W, band, scale, 3)
    np.testing.assert_array_equal(m_runs, runs.numpy())
    np.testing.assert_array_equal(l_runs, runs.numpy())
    np.testing.assert_array_equal(m_cnt, iters.numpy())
    assert m_sat == l_sat == bool(sat)
    assert seen["calls"] > 0
    assert (m_cnt == W + 4).any()                  # stopped by tile_bound
    assert (m_cnt[:, 2] == 0).all()


# ---------------------------------------------------- dispatch on the CPU

def test_wrappers_take_the_plain_walks_on_cpu():
    """CPU tensors reach the plain walks: no launch, no plain CUDA call,
    the host syncs counted; `saturated` a 0-dim bool tensor on the CPU."""
    q, t, lens = _reads(4, 4, 256, 24)
    v, nm, lt = _dirs(q, t, lens, 24, 128)
    counts = (ttb.device_traceback_c.launches, tg.gact_traceback_c.launches,
              ttb.device_traceback_c_plain.cuda_calls,
              tg.gact_traceback_c_plain.cuda_calls)
    syncs = (ttb.device_traceback_c.host_syncs,
             tg.gact_traceback_c.host_syncs)
    got = ttb.device_traceback_c(v, lt, 256, 24, nm)
    assert torch.equal(got, ttb.device_traceback_c_plain(v, lt, 256, 24, nm))
    tq, tt = torch.from_numpy(q), torch.from_numpy(t)
    ckpt, _ = tg.gact_forward(tq, tt, 64, 24, 128)
    runs, sat = tg.gact_traceback_c(tq, tt, ckpt, lt, 64, 24, 128)
    assert sat.device.type == "cpu" and sat.dtype == torch.bool
    assert sat.shape == () and not bool(sat)
    assert (ttb.device_traceback_c.launches, tg.gact_traceback_c.launches,
            ttb.device_traceback_c_plain.cuda_calls,
            tg.gact_traceback_c_plain.cuda_calls) == counts
    assert ttb.device_traceback_c.host_syncs > syncs[0]
    assert tg.gact_traceback_c.host_syncs > syncs[1]


def test_gact_walk_marks_each_group():
    """mark("dirs") after each group's rematerialization, mark("walk")
    after its walk, newest group first."""
    from test_torch_gact import _pair
    q, t, lens = (torch.from_numpy(a) for a in _pair(2, 3, 512))
    ckpt, _ = tg.gact_forward(q, t, 64, 20, 128)
    marks = []
    tg.gact_traceback_c(q, t, ckpt, lens, 64, 20, 128, group=3,
                        mark=marks.append)
    assert marks == ["dirs", "walk"] * 3          # 8 tiles: 3 + 3 + 2


# ------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band,wide", [
    (37, 256, 24, 128, False),
    (300, 2048, 204, 512, True),
    (2048, 1024, 102, 256, False),     # the 1 kb main shape
    (200, 10240, 512, 1152, True),     # the 10 kb resident pass
    (1, 1024, 102, 256, False),        # one lane
    (3, 2048, 204, 512, False)])       # a CTA's lanes not all in B
def test_walk_c_kernel_matches_plain_on_card(B, L, W, band, wide):
    _card()
    from _torch_parity import mutate_rows
    from longreadmapper_tpu_torch.ops.band_dp import banded_nw_dirs
    rng = np.random.default_rng(B + L)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = mutate_rows(rng, q, L // 40, pad=L // 16)
    qd, td = torch.from_numpy(q).cuda(), torch.from_numpy(t).cuda()
    v, wc, nm = banded_nw_dirs(qd, td, W, band)
    lens = torch.full((B,), L - L // 16, dtype=torch.int32, device="cuda")
    if B > 1:
        lens[::5] = 0
    ed = wc[lens.long(), torch.arange(B, device="cuda")]
    lens = torch.where(ed.int() <= W, lens, 0)
    dt = torch.int32 if wide else torch.int16
    n0 = ttb.device_traceback_c.launches
    got = ttb.device_traceback_c(v, lens, L, W, nm, dt)
    want = ttb.device_traceback_c_plain(v, lens, L, W, nm, dt)
    torch.cuda.synchronize()
    assert ttb.device_traceback_c.launches == n0 + 1
    assert torch.equal(got, want)
    assert (lens > 0).sum() > B // 2


@pytest.mark.cuda
def test_walk_c_kernel_clamps_on_card():
    _card()
    rng = np.random.default_rng(5)
    G, B, band, W = 70, 64, 128, 30
    v = torch.from_numpy(rng.integers(-2**31, 2**31, (G, B, band),
                                      dtype=np.int64).astype(np.int32))
    nm = torch.from_numpy(rng.integers(-2**31, 2**31, (3, B, band),
                                       dtype=np.int64).astype(np.int32))
    lens = torch.from_numpy(rng.integers(-3, 16 * G + 40, B).astype(
        np.int32))
    from longreadmapper_tpu_torch import native_build
    lib = native_build.load("walk", ttb.WALK_FUNCS)
    n_iter = ttb.traceback_c_iters(16 * G, W)
    vd, nmd, ld = v.cuda(), nm.cuda(), lens.cuda()
    for dt in (torch.int16, torch.int32):
        got = ttb.device_traceback_c(vd, ld, 16 * G, W, nmd, dt)
        want = ttb.device_traceback_c_plain(v, lens, 16 * G, W, nm, dt)
        assert torch.equal(got.cpu(), want)
        # the kernel writes every element: a buffer of garbage comes back
        # equal to the plain walk's runs
        runs = torch.empty((B, 2 * n_iter), dtype=dt, device="cuda")
        runs.fill_(-21846)
        assert lib.lrm_walk_c(
            vd.data_ptr(), nmd.data_ptr(), ld.data_ptr(), G, B, band, W,
            n_iter, runs.data_ptr(), runs.element_size(),
            torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(runs.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,T,W,band,scale,group,weave", [
    (40, 4096, 512, 409, 896, 1, 3, False),
    (1, 4096, 512, 409, 896, 1, 3, False),    # one lane, one CTA
    (31, 4096, 512, 409, 896, 1, 1, False),   # a group a tile
    (32, 4096, 512, 409, 896, 4, 3, False),   # scale 4
    (33, 4096, 512, 409, 896, 1, 8, False),   # one group
    (200, 4096, 512, 204, 512, 1, 2, False),
    (33, 8192, 1024, 300, 640, 1, 3, False),  # G 64: two bitmap words
    (33, 8192, 2048, 300, 640, 4, 2, False),  # G 128: rings past 48 KB
    (1100, 1024, 128, 60, 128, 1, 3, False),  # more lanes than threads
    (4, 2048, 128, 32, 128, 1, 3, True)])     # saturates at scale 1
def test_gact_walk_kernel_matches_plain_on_card(B, L, T, W, band, scale,
                                                group, weave):
    """runs, saturated and each lane's iterations in each tile equal the
    plain walk's."""
    _card()
    rng = np.random.default_rng(B + L)
    if weave:
        from test_torch_gact import _weave
        q, t, lens = _weave(B, L, T, 24)
    else:
        from _torch_parity import mutate_rows
        q = rng.integers(0, 4, (B, L)).astype(np.int8)
        t = mutate_rows(rng, q, L // 40, pad=L // 16)
        lens = np.full(B, L - L // 16, np.int32)
        lens[::7] = 0
    qd, td, ld = (torch.from_numpy(a).cuda() for a in (q, t, lens))
    ckpt, _ = tg.gact_forward(qd, td, T, W, band)
    K = L // T
    iters = torch.full((K, B), -1, dtype=torch.int32, device="cuda")
    iters_p = torch.zeros((K, B), dtype=torch.int32, device="cuda")
    n0 = tg.gact_traceback_c.launches
    got, sat = tg.gact_traceback_c(qd, td, ckpt, ld, T, W, band, scale,
                                   group, iters=iters)
    want, sat_p = tg.gact_traceback_c_plain(qd, td, ckpt, ld, T, W, band,
                                            scale, group, iters=iters_p)
    torch.cuda.synchronize()
    assert tg.gact_traceback_c.launches == n0 + -(-K // group)
    assert torch.equal(got, want)
    assert torch.equal(iters, iters_p)
    assert sat.dtype == torch.bool and sat.device.type == "cuda"
    assert bool(sat) == bool(sat_p) == weave


@pytest.mark.cuda
def test_gact_walk_kernel_keeps_lanes_past_shared_memory_on_card():
    """20,000 lanes, more than one CTA's shared memory would hold at 12
    bytes a lane (the bound of the one-CTA walk before the warp a lane):
    runs and the saturated flag equal the plain walk's (a bound JAX does
    not have, ROADMAP.md C2)."""
    _card()
    from _torch_parity import mutate_rows
    B, L, T, W, band = 20000, 256, 64, 20, 128
    assert 12 * B > 227 * 1024
    rng = np.random.default_rng(20000)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = mutate_rows(rng, q, 4, pad=16)
    lens = np.full(B, L - 16, np.int32)
    lens[::9] = 0
    qd, td, ld = (torch.from_numpy(a).cuda() for a in (q, t, lens))
    ckpt, wcol = tg.gact_forward(qd, td, T, W, band)
    ed = wcol[ld.long(), torch.arange(B, device="cuda")].int()
    ld = torch.where(ed < W, ld, 0)
    n0 = tg.gact_traceback_c.launches
    got, sat = tg.gact_traceback_c(qd, td, ckpt, ld, T, W, band, 1, 2)
    want, sat_p = tg.gact_traceback_c_plain(qd, td, ckpt, ld, T, W, band, 1,
                                            2)
    torch.cuda.synchronize()
    assert tg.gact_traceback_c.launches == n0 + 2
    assert torch.equal(got, want)
    assert sat.dtype == torch.bool and bool(sat) == bool(sat_p)
    assert int((ld > 0).sum()) > B // 2


@pytest.mark.cuda
def test_gact_walk_kernel_on_random_words_on_card(monkeypatch):
    """Random direction words and bitmaps that agree with nothing: lanes
    wander across the band, hit its edges and the tile bound; the kernel
    equals the plain walk, run after run (the CTA ticket back at 0)."""
    _card()
    B, L, T, W, band = 70, 2048, 512, 60, 192
    words = _random_groups(monkeypatch, seed=9)
    q = torch.zeros((B, L), dtype=torch.int8, device="cuda")
    lens = torch.from_numpy(np.random.default_rng(9).integers(
        -3, L + 40, B).astype(np.int32)).cuda()
    ckpt = torch.zeros((L // T + 1, B, band), dtype=torch.int32,
                       device="cuda")
    want = tg.gact_traceback_c_plain(q, q, ckpt, lens, T, W, band, 1, 3)
    for _ in range(2):
        got = tg.gact_traceback_c(q, q, ckpt, lens, T, W, band, 1, 3)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert bool(got[1]) == bool(want[1])
    assert words["calls"] > 0
