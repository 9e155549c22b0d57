"""The CIGAR walks' CUDA kernels (csrc/walk.cu) on the CPU, through scalar
per-lane models of their loops, and on the card against the plain walks.

The models below are written as the CUDA code is written, lane by lane in
Python integers: walk_c_kernel's independent lanes, each to done or to its
iteration bound, with the bitmap scan that starts at g_cur's own word and
stops at the first hit; gact_walk_kernel's shared write pointer, its
per-tile "any lane alive" loop and the clamped last row that every lane's
pair overwrites.  Each model is held equal to the port's plain walk and to
JAX's device_traceback_c / gact_traceback_c: ragged lengths, two or more
bitmap words, int32 entries, dead lanes, random words for the clamps, and
a forced saturation at scale 1.  The wrappers' dispatch on a CPU tensor
reaches the plain walk.

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


def _group_below(nm, b, band, g_cur, bmidx):
    """walk.cu::group_below: from min(nbm-1, g_cur >> 5) down, the first
    non-zero masked bitmap word gives the group.  nm (nbm, B*band) of
    uint32 Python ints."""
    w = min(len(nm) - 1, g_cur >> 5)
    bwk = nm[w][bmidx] & _below_mask(g_cur, w)
    while bwk == 0 and w > 0:
        w -= 1
        bwk = nm[w][bmidx] & _below_mask(g_cur, w)
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
            g2 = -1 if in_cur else _group_below(nmw, b, band, g_cur, bmidx)
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


def model_gact_walk(q, t, ckpt, lens, T, W, band, scale=1, group=1):
    """gact_walk_kernel over every group of ops/gact._for_each_group (the
    plain tile groups on the CPU): one state for all lanes, one shared
    write pointer, each tile's loop until no lane is alive.  Returns
    (runs (B, gact_runs_cols_c), saturated)."""
    B, L = q.shape
    n_rows = tg.gact_runs_cols_c(L, T, W, scale) // 2
    buf = np.full((B, n_rows, 2), 3, np.int64)
    st = dict(i=[int(x) for x in lens], j=[int(x) for x in lens],
              done=[int(x) <= 0 for x in lens], ptr=0, nsat=0)

    def walk(k_lo, k_hi, vg, nmg):
        for k in range(k_hi, k_lo - 1, -1):
            v = _u32(vg[k - k_lo])
            nmw = [_u32(w) for w in nmg[k - k_lo]]
            lo = k * T
            i, j, done = st["i"], st["j"], st["done"]
            for _ in range(W + 4):
                if not any(not done[b] and (i[b] > lo or (k == 0
                                                          and j[b] > 0))
                           for b in range(B)):
                    break
                ptr = st["ptr"]
                for b in range(B):
                    in_tile = i[b] > lo
                    active = not done[b] and (in_tile or (k == 0
                                                          and j[b] > 0))
                    e1 = e2 = 3
                    if active:
                        any_nm, gstar, wsel = False, 0, 0
                        if in_tile:
                            d = _clamp(j[b] - i[b] + W, 0, band - 1)
                            ii = _clamp(i[b] - 1 - lo, 0, T - 1)
                            g_cur, r = ii >> 4, ii & 15
                            sh = 2 * (15 - r)
                            wm = ((_word(v, g_cur, b, d, B, band) << sh)
                                  & M32) >> sh
                            bmidx = _clamp(b * band + d, 0, B * band - 1)
                            g2 = -1 if wm else _group_below(nmw, b, band,
                                                            g_cur, bmidx)
                            any_nm = wm != 0 or g2 >= 0
                            gstar = g_cur if wm else max(g2, 0)
                            wsel = (wm if wm else
                                    _word(v, gstar, b, d, B, band)
                                    if any_nm else 0)
                        pstar = max(15 - (_clz(wsel) >> 1), 0)
                        floor_row = (lo + gstar * 16 + pstar + 1 if any_nm
                                     else (0 if k == 0 else lo))
                        mrun = i[b] - floor_row if in_tile else 0
                        i2, j2 = i[b] - mrun, j[b] - mrun
                        op = (wsel >> (2 * pstar)) & 3
                        take_e = any_nm and not (i2 == 0 and j2 == 0)
                        i3 = i2 - 1 if take_e and op == 1 else i2
                        j3 = j2 - 1 if take_e and op == 2 else j2
                        drun = max(j2, 0) if not any_nm and i2 == 0 else 0
                        if mrun > 0:
                            e1 = _entry(mrun, 0, 16)
                        if take_e:
                            e2 = _entry(1, op, 16)
                        elif drun > 0:
                            e2 = _entry(drun, 2, 16)
                        i[b], j[b] = i3, 0 if drun > 0 else j3
                    if i[b] == 0 and j[b] == 0:
                        done[b] = True
                    # every lane's pair, pads included, into the shared row
                    buf[b, ptr] = (e1, e2)
                st["nsat"] += ptr == n_rows - 1
                st["ptr"] = min(ptr + 1, n_rows - 1)

    tg._for_each_group(torch.from_numpy(q), torch.from_numpy(t), ckpt, T,
                       W, band, group,
                       lambda k_lo, k_hi, vg, nmg: walk(k_lo, k_hi,
                                                        vg.numpy(),
                                                        nmg.numpy()), None)
    return buf.reshape(B, -1).astype(np.int16), st["nsat"] >= 2


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
    got = [_group_below(words, 0, 0, int(g_cur[k]), k) for k in range(n)]
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
    (2048, 1024, 102, 256, False)])    # the 1 kb main shape
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
    for dt in (torch.int16, torch.int32):
        got = ttb.device_traceback_c(v.cuda(), lens.cuda(), 16 * G, W,
                                     nm.cuda(), dt)
        want = ttb.device_traceback_c_plain(v, lens, 16 * G, W, nm, dt)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,T,W,band,scale,group,weave", [
    (40, 4096, 512, 409, 896, 1, 3, False),
    (1100, 1024, 128, 60, 128, 1, 3, False),  # more lanes than threads
    (4, 2048, 128, 32, 128, 1, 3, True)])     # saturates at scale 1
def test_gact_walk_kernel_matches_plain_on_card(B, L, T, W, band, scale,
                                                group, weave):
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
    n0 = tg.gact_traceback_c.launches
    got, sat = tg.gact_traceback_c(qd, td, ckpt, ld, T, W, band, scale,
                                   group)
    want, sat_p = tg.gact_traceback_c_plain(qd, td, ckpt, ld, T, W, band,
                                            scale, group)
    torch.cuda.synchronize()
    assert tg.gact_traceback_c.launches == n0 + -(-(L // T) // group)
    assert torch.equal(got, want)
    assert sat.dtype == torch.bool and sat.device.type == "cuda"
    assert bool(sat) == bool(sat_p) == weave


@pytest.mark.cuda
def test_gact_walk_kernel_keeps_lanes_past_shared_memory_on_card():
    """20,000 lanes: 12 bytes a lane pass the card's 227 KB a block, so
    the kernel keeps the lanes' state in global memory; runs and the
    saturated flag equal the plain walk's (a bound JAX does not have,
    ROADMAP.md C2)."""
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
