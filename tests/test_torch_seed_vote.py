"""The seed vote's plain versions (ops/seed_vote.py: seed_tables_plain,
pick_wide_seeds, vote_rows_plain, seed_accept_plain) against the JAX
step's intermediates on the same chunk, and the accept against the
reference's per-read loop (oracle/refpipe.py) on crafted rows.

JAX's _seed_vote runs eagerly with its _narrow_wide_seeds and top2_votes
wrapped, so the test reads their inputs (the per-seed tables qw, k12,
cnt12, wide), their outputs (k_seed, cnt, the rows that lost a wide
seed; each row's v1, key1, v2) and JAX's row totals (the cumsum of cnt).
Cases: the full and slim layouts, the split-hi pos64 layouts (JAX in x64
mode in a subprocess), left == 0 (seed_len == hlen), wide seeds on a
tandem repeat (LF-narrowed) with and without a lane budget that drops
some, rows past C on the repeat, and the exact tier.  Every comparison is
exact.  The wrappers' dispatch on a CPU tensor reaches the plain versions
(the kernels: tests/test_torch_seed_vote_card.py).  seed_accept_plain
against OracleMapper.best_location's phase loop (its _Histo): no phase
accepted, the first, only the last (the overwrite), num_seeds 0, ties in
the outer histogram, overflow only after the accepted phase, int64 keys,
and random rows."""

import json
import os
import subprocess
import sys
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import sample_reads
from _torch_parity import e2e_fixture, repeat_fixture
from longreadmapper_tpu.index import device as jdevice
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.oracle.refpipe import _Histo
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.index import device as tdevice
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.ops import vote as tvote

torch.set_num_threads(1)
HLEN = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    return e2e_fixture(tmp_path_factory.mktemp("torch_seed_vote"))


@pytest.fixture(scope="module")
def rep(tmp_path_factory):
    return repeat_fixture(tmp_path_factory.mktemp("torch_seed_vote_rep"))


def jax_intermediates(jc, jidx, codes, lens):
    """JAX's _seed_vote on one chunk, eagerly, with its wide-seed narrowing
    and top-2 wrapped: the per-seed tables, the narrowing's outputs, each
    row's top-2 and total, and (best, overflow)."""
    got = {}
    narrow, top2 = jpipe._narrow_wide_seeds, jpipe.top2_votes

    def narrow_spy(cfg, idx, wide, k12, l12, cnt12, qw):
        out = narrow(cfg, idx, wide, k12, l12, cnt12, qw)
        got.update(wide=wide, k12=k12, cnt12=cnt12, qw=qw, k_seed=out[0],
                   cnt=out[1], row_overflow=out[2],
                   total=jnp.cumsum(out[1], axis=1)[:, -1])
        return out

    def top2_spy(keys, valid):
        out = top2(keys, valid)
        got.update(v1=out[0], key1=out[1], v2=out[2])
        return out

    jpipe._narrow_wide_seeds, jpipe.top2_votes = narrow_spy, top2_spy
    try:
        best, overflow = jpipe._seed_vote(jc, jidx, jnp.asarray(codes),
                                          jnp.asarray(lens))
    finally:
        jpipe._narrow_wide_seeds, jpipe.top2_votes = narrow, top2
    got.update(best=best, overflow=overflow)
    return {k: np.asarray(v) for k, v in got.items()}


def port_intermediates(tc, tidx, codes, lens):
    """The same quantities from the port's plain versions."""
    codes, lens = torch.from_numpy(codes), torch.from_numpy(lens)
    qw, k12, cnt12, wide, kw, cw = tsv.seed_tables_plain(tc, tidx, codes,
                                                         lens)
    k_seed, cnt, row_overflow = tsv.pick_wide_seeds(
        tc, wide, k12, cnt12, kw, cw, tsv.wide_rank(wide))
    v1, key1, v2, total = tsv.vote_rows_plain(tc, tidx, k_seed, cnt, qw,
                                              wide)
    best, overflow = tpipe._seed_vote(tc, tidx, codes, lens)
    return {k: v.numpy() for k, v in dict(
        qw=qw, k12=k12, cnt12=cnt12, wide=wide, k_seed=k_seed, cnt=cnt,
        row_overflow=row_overflow, v1=v1, key1=key1, v2=v2, total=total,
        best=best, overflow=overflow).items()}


def _chunk(d, params, reads, B, L, tidx, tmeta):
    tm = TorchMapper(tidx, tmeta, d["mta"], params, chunk_b=B, device="cpu")
    codes, _, lens, _ = tm._pack_reads(reads, L, B)
    return codes, lens


def _compare(want, got):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _both(d, params, reads, B=16, L=256, slim=False, **kw):
    args = (d["fmi"], d["kl"], HLEN, d["cat"], d["mta"])
    jidx, jmeta = (jdevice.build_device_index(*args, slim=True) if slim
                   else (d["idx"], d["meta"]))
    tidx, tmeta = (tdevice.build_device_index(*args, "cpu", slim=True)
                   if slim else (d["tidx"], d["tmeta"]))
    jc = replace(jpipe.MapperConfig.from_params(params, jmeta, B, L), **kw)
    tc = replace(tpipe.MapperConfig.from_params(params, tmeta, B, L), **kw)
    codes, lens = _chunk(d, params, reads, B, L, tidx, tmeta)
    want = jax_intermediates(jc, jidx, codes, lens)
    got = port_intermediates(tc, tidx, codes, lens)
    _compare(want, got)
    return tc, got


def _e2e_reads(d, n=12):
    rng = np.random.default_rng(31)
    reads = sample_reads(rng, d["chrA"], n, 200, error_rate=0.03)
    reads = [(nm, s, None) for nm, s, *_ in reads]
    s = np.frombuffer(reads[0][1].encode(), np.uint8).copy()
    s[rng.integers(0, len(s), 6)] = ord("N")
    reads[0] = (reads[0][0], s.tobytes().decode(), None)
    return reads + [("short", d["chrB"][100:115], None)]


@pytest.mark.parametrize("slim", [False, True])
@pytest.mark.parametrize("seed_len", [20, HLEN])      # HLEN: left == 0
def test_plain_seed_vote_matches_jax_layouts(e2e, slim, seed_len):
    tc, got = _both(e2e, Params(hlen=HLEN, seed_len=seed_len, thres=300),
                    _e2e_reads(e2e), slim=slim)
    assert tc.left == seed_len - HLEN
    assert (got["v1"] > 0).sum() > got["v1"].shape[0] // 4
    assert not got["wide"].any()


def test_plain_seed_vote_matches_jax_exact_tier(e2e):
    tc, got = _both(e2e, Params(hlen=HLEN, seed_len=20, thres=300),
                    _e2e_reads(e2e), exact_slots=True)
    assert tc.vote_slots == tc.vote_slots_exact > 64


@pytest.mark.parametrize("wide_budget", [0, 4])
def test_plain_seed_vote_matches_jax_wide_seeds(rep, wide_budget):
    """The repeat's seeds are wide (LF-narrowed); a 4-lane budget drops
    some, whose rows flag overflow."""
    tc, got = _both(rep, Params(hlen=HLEN, thres=30), rep["reads"], B=8,
                    wide_budget=wide_budget)
    assert got["wide"].any()
    assert got["row_overflow"].any() == (wide_budget == 4)


@pytest.mark.parametrize("exact", [False, True])
def test_plain_seed_vote_matches_jax_rows_past_c(rep, exact):
    """Below thres the repeat's seeds are not wide but vote ~40 times
    each: their rows pass C in the compact tier (the overflow of bit 0),
    and in the exact tier too (the mapper's exact tier is sized for the
    genome's background, not for a repeat)."""
    tc, got = _both(rep, Params(hlen=HLEN, thres=300), rep["reads"], B=8,
                    exact_slots=exact)
    assert not got["wide"].any()
    if not exact:
        assert (got["total"] > tc.vote_slots).any() and got["overflow"].any()


def test_pick_without_wide_seeds_is_the_no_wide_branch(e2e):
    """With no wide seed the always-run pick returns JAX's other branch
    bit for bit: k12, cnt12 and no row overflow (ROADMAP.md B3.4)."""
    params = Params(hlen=HLEN, seed_len=20, thres=300)
    tc = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 16, 256)
    codes, lens = _chunk(e2e, params, _e2e_reads(e2e), 16, 256, e2e["tidx"],
                         e2e["tmeta"])
    qw, k12, cnt12, wide, kw, cw = tsv.seed_tables_plain(
        tc, e2e["tidx"], torch.from_numpy(codes), torch.from_numpy(lens))
    assert not wide.any()
    k_seed, cnt, ovf = tsv.pick_wide_seeds(tc, wide, k12, cnt12, kw, cw,
                                           tsv.wide_rank(wide))
    assert k_seed.dtype == k12.dtype and torch.equal(k_seed, k12)
    assert cnt.dtype == torch.int32 and torch.equal(cnt, cnt12)
    assert ovf.dtype == torch.bool and not ovf.any()
    assert ovf.shape == (wide.shape[0],)


def test_pick_keeps_the_first_wide_lanes_in_flat_order():
    """The rank picks the first wide_lanes wide seeds in flat order, as
    JAX's stable sort of the wide flags does, and no more than there
    are lanes."""
    cfg = replace(tpipe.MapperConfig(B=2, L=64, seed_len=20, gap_len=1,
                                     thres=30, hlen=6, n=1000, dollar_pos=3,
                                     accept_score=0.6, error_rate=0.1),
                  wide_budget=3)
    wide = torch.tensor([[0, 1, 0, 1], [1, 0, 1, 1]], dtype=torch.bool)
    k12 = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    cnt12 = torch.full((2, 4), 30, dtype=torch.int32)
    kw, cw = k12 + 100, torch.full((2, 4), 7, dtype=torch.int32)
    k_seed, cnt, ovf = tsv.pick_wide_seeds(cfg, wide, k12, cnt12, kw, cw,
                                           tsv.wide_rank(wide))
    assert k_seed.tolist() == [[0, 101, 2, 103], [104, 5, 6, 7]]
    assert cnt.tolist() == [[30, 7, 30, 7], [7, 30, 0, 0]]
    assert ovf.tolist() == [False, True]
    cfg = replace(cfg, wide_budget=100)         # more lanes than seeds
    assert not tsv.pick_wide_seeds(cfg, wide, k12, cnt12, kw, cw,
                                   tsv.wide_rank(wide))[2].any()


def test_wrappers_take_the_plain_versions_on_cpu(e2e):
    """CPU tensors reach the plain versions: no launch, no plain call
    counted on the card, results equal; vote_rows is the pick, the vote
    and the accept (vote_accept_plain), its rows vote_rows_plain's."""
    params = Params(hlen=HLEN, seed_len=20, thres=300)
    tc = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 16, 256)
    codes, lens = (torch.from_numpy(a) for a in _chunk(
        e2e, params, _e2e_reads(e2e), 16, 256, e2e["tidx"], e2e["tmeta"]))
    counts = (tsv.seed_tables.launches, tsv.vote_rows.launches,
              tvote.top2_votes.launches, tsv.seed_tables_plain.cuda_calls,
              tsv.vote_rows_plain.cuda_calls,
              tsv.seed_accept_plain.cuda_calls,
              tvote.top2_votes_plain.cuda_calls)
    tabs = tsv.seed_tables(tc, e2e["tidx"], codes, lens)
    for g, w in zip(tabs, tsv.seed_tables_plain(tc, e2e["tidx"], codes,
                                                lens)):
        assert torch.equal(g, w)
    qw, k12, cnt12, wide, kw, cw = tabs
    rank = tsv.wide_rank(wide)
    best, overflow, rows = tsv.vote_rows(tc, e2e["tidx"], lens, tabs, rank)
    want = tsv.vote_accept_plain(tc, e2e["tidx"], lens, tabs, rank)
    for g, w in zip((best, overflow) + rows, want[:2] + want[2]):
        assert torch.equal(g, w)
    for g, w in zip(rows, tsv.vote_rows_plain(tc, e2e["tidx"], k12, cnt12,
                                              qw, wide)):
        assert torch.equal(g, w)
    assert not rows[4].any()
    for g, w in zip((best, overflow), tsv.seed_accept_plain(
            tc, lens, *rows)):
        assert torch.equal(g, w)
    keys = torch.arange(-40, 40, dtype=torch.int32).reshape(4, 20)
    valid = keys % 3 != 0
    for g, w in zip(tvote.top2_votes(keys, valid),
                    tvote.top2_votes_plain(keys, valid)):
        assert torch.equal(g, w)
    assert (tsv.seed_tables.launches, tsv.vote_rows.launches,
            tvote.top2_votes.launches, tsv.seed_tables_plain.cuda_calls,
            tsv.vote_rows_plain.cuda_calls,
            tsv.seed_accept_plain.cuda_calls,
            tvote.top2_votes_plain.cuda_calls) == counts


def test_seed_vote_marks_its_stages(e2e):
    params = Params(hlen=HLEN, seed_len=20, thres=300)
    tc = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 16, 256)
    codes, lens = (torch.from_numpy(a) for a in _chunk(
        e2e, params, _e2e_reads(e2e), 16, 256, e2e["tidx"], e2e["tmeta"]))
    marks = []
    got = tpipe._seed_vote(tc, e2e["tidx"], codes, lens, marks.append)
    want = tpipe._seed_vote(tc, e2e["tidx"], codes, lens)
    assert marks == ["seed_tables", "narrow", "vote_rows", "accept"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _accept_cfg(B):
    """Five phases of step 5 (seed_len 4, gap 1): 20 seeds at length 100,
    accepted above 12 votes (accept_score 0.6)."""
    return tpipe.MapperConfig(B=B, L=128, seed_len=4, gap_len=1, thres=300,
                              hlen=4, n=100_000, dollar_pos=3,
                              accept_score=0.6, error_rate=0.1)


def oracle_accept(cfg, rlen, v1, key1, v2, total, wovf):
    """OracleMapper.best_location's phase loop (alnmain.c:330-403) on one
    read's per-phase top-2, and the overflow of the phases it runs (those
    up to the accepted one, all if none)."""
    P = cfg.phases
    outer, best, acc, ovf = _Histo(), None, None, False
    num_seeds = rlen // cfg.step
    for it in range(P):
        ovf = ovf or total[it] > cfg.vote_slots or bool(wovf[it])
        if num_seeds > 0:
            if (v1[it] + v2[it]) / num_seeds > cfg.accept_score:
                best, acc = int(key1[it]), it
                break
            if v1[it] != 0:
                outer.add(int(key1[it]))
    if best is None or acc == P - 1:
        best = outer.find_2_max()[0][0]
    return best, ovf


# crafted reads of five phases: (length, v1, key1, v2, total over C at
# these phases, dropped wide seeds at these phases); C = vote_slots
ACCEPT_CASES = {
    # no phase passes 12 votes: the outer histogram of every phase
    "none": (100, [5, 6, 0, 5, 4], [160, 165, 999, 300, 161],
             [1, 2, 0, 1, 1], [], [2]),
    # the first phase: its key1
    "first": (100, [10, 3, 3, 3, 3], [400, 160, 160, 160, 160],
              [5, 0, 0, 0, 0], [], []),
    # only the last: overwritten by the earlier phases' top-1
    "last": (100, [5, 6, 0, 5, 11], [160, 300, 999, 305, 700],
             [1, 2, 0, 1, 3], [], []),
    # lens < step: no seeds, nothing accepted, best 0, every phase runs
    "no_seeds": (3, [5, 6, 0, 5, 11], [160, 300, 999, 305, 700],
                 [1, 2, 0, 1, 3], [4], []),
    # two buckets of two phases each: the one seen first wins, at its
    # minimum key
    "ties": (100, [4, 4, 4, 4, 4], [310, 175, 305, 170, 900],
             [0, 0, 0, 0, 0], [], []),
    # accepted at phase 1: overflow at phase 3 never ran
    "late_overflow": (100, [4, 12, 1, 1, 1], [160, 165, 999, 300, 161],
                      [1, 2, 0, 1, 1], [3], [4]),
    # ... but at the accepted phase it counts
    "overflow_at_accept": (100, [4, 12, 1, 1, 1], [160, 165, 999, 300, 161],
                           [1, 2, 0, 1, 1], [1], []),
    # negative keys and a bucket that spans no sign change
    "negative": (100, [3, 3, 3, 0, 3], [-20, -17, 5, 0, -30],
                 [0, 0, 0, 0, 0], [], []),
}


def _accept_rows(cfg, reads, dtype):
    """The (B*P,) row tensors of `reads`, each (length, v1, key1, v2,
    phases over C, phases with dropped wide seeds)."""
    B, P, C = len(reads), cfg.phases, cfg.vote_slots
    lens = torch.tensor([r[0] for r in reads], dtype=torch.int32)
    v1, key1, v2 = (torch.tensor([r[i] for r in reads]).reshape(-1)
                    for i in (1, 2, 3))
    total = torch.full((B, P), C // 2, dtype=torch.int32)
    wovf = torch.zeros((B, P), dtype=torch.bool)
    for b, r in enumerate(reads):
        total[b, r[4]] = C + 1
        wovf[b, r[5]] = True
    return (lens, v1.to(torch.int32), key1.to(dtype), v2.to(torch.int32),
            total.reshape(-1), wovf.reshape(-1))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", list(ACCEPT_CASES) + ["random"])
def test_seed_accept_plain_matches_the_reference_loop(case, dtype):
    """seed_accept_plain on crafted rows against the reference's phase
    loop, read by read; int64 keys past 2^32 under int64."""
    if case == "random":
        rng = np.random.default_rng(17)
        reads = [(int(rng.integers(0, 130)),
                  rng.integers(0, 14, 5).tolist(),
                  (rng.integers(-3, 4, 5) * 16
                   + rng.integers(0, 16, 5)).tolist(),
                  rng.integers(0, 4, 5).tolist(),
                  np.flatnonzero(rng.random(5) < 0.2).tolist(),
                  np.flatnonzero(rng.random(5) < 0.1).tolist())
                 for _ in range(300)]
    else:
        reads = [ACCEPT_CASES[case]]
    if dtype == torch.int64:
        reads = [(r[0], r[1], [k + (5 << 32) for k in r[2]]) + r[3:]
                 for r in reads]
    cfg = _accept_cfg(len(reads))
    rows = _accept_rows(cfg, reads, dtype)
    best, overflow = tsv.seed_accept_plain(cfg, *rows)
    assert best.dtype == dtype and overflow.dtype == torch.bool
    want = [oracle_accept(cfg, r[0], r[1], r[2], r[3],
                          rows[4].reshape(len(reads), -1)[b].tolist(),
                          rows[5].reshape(len(reads), -1)[b].tolist())
            for b, r in enumerate(reads)]
    assert best.tolist() == [w[0] for w in want]
    assert overflow.tolist() == [w[1] for w in want]
    if case == "ties":
        assert best.tolist() == [305 + (5 << 32 if dtype == torch.int64
                                        else 0)]


# ------------------------------------------ seed_tables_kernel's schedule
# Scalar models of csrc/vote.cu::seed_tables_kernel as it is written: the
# CTA split (seed_part: whole phase rows or a slice of one a CTA), each
# CTA's window packed from its codes (2 bits a code, an `inv` bit for
# codes outside 0-3 and past L, an `exo` bit for codes outside 0-4), a
# seed's qw, lchash key and validity read from the packed words, and the
# wide seeds' queue narrowed after the main pass.

SEEDS_PER_CTA, SEED_THREADS = 1024, 512


def model_seed_part(cfg):
    """(np, ns, cpr, chunks): phase rows and seeds of a row a CTA, CTAs a
    row, CTAs a read: whole rows a CTA while a read's rows are short,
    else slices of one row."""
    P, S = cfg.phases, cfg.max_seeds
    if S >= SEEDS_PER_CTA:
        cpr = -(-S // SEEDS_PER_CTA)
        return 1, -(-S // cpr), cpr, P * cpr
    n_p = min(SEEDS_PER_CTA // S, P)
    return n_p, S, 1, -(-P // n_p)


def model_ctas(cfg):
    """Each CTA's (p0, np, s0, ns) for one read."""
    n_p, ns, cpr, chunks = model_seed_part(cfg)
    for c in range(chunks):
        p0, s0 = c // cpr * n_p, c % cpr * ns
        yield p0, min(n_p, cfg.phases - p0), s0, min(ns, cfg.max_seeds - s0)


def _rev2(x, n):
    """The n 2-bit fields of x in reverse order."""
    return sum(((x >> (2 * t)) & 3) << (2 * (n - 1 - t)) for t in range(n))


def model_packed_seeds(cfg, codes):
    """qw, num (the lchash key) and ok per seed, (B*P, S) each, as the
    kernel reads them from each CTA's packed window."""
    B, L = codes.shape
    P, S, step = cfg.phases, cfg.max_seeds, cfg.step
    sl, left, hlen = cfg.seed_len, cfg.left, cfg.hlen
    qw = np.zeros((B * P, S), np.int64)
    num = np.zeros((B * P, S), np.int64)
    ok = np.zeros((B * P, S), bool)
    for b in range(B):
        row = [int(c) for c in codes[b]]
        for p0, n_p, s0, ns in model_ctas(cfg):
            wlo = (p0 + step * s0) & ~15
            units = (p0 + n_p - 1 + step * (s0 + ns - 1) + sl - wlo
                     + 15) // 16 + 2
            cw, inv, exo = [], [], []
            for u in range(units):
                cs = [row[x] if x < L else 4
                      for x in range(wlo + 16 * u, wlo + 16 * u + 16)]
                cw.append(sum((c & 3) << (2 * t) for t, c in enumerate(cs)))
                inv.append(sum((not 0 <= c <= 3) << t
                               for t, c in enumerate(cs)))
                exo.append(sum((not 0 <= c <= 4) << t
                               for t, c in enumerate(cs)))
            for lc in range(n_p * ns):
                p, s = p0 + lc // ns, s0 + lc % ns
                j = p + step * s
                x = j - wlo
                u = x >> 4
                bits = (cw[u] | cw[u + 1] << 32 | cw[u + 2] << 64) >> (
                    2 * (x & 15))
                iv = ((inv[u] | inv[u + 1] << 16 | inv[u + 2] << 32)
                      >> (x & 15)) & ((1 << sl) - 1)
                ex = ((exo[u] | exo[u + 1] << 16 | exo[u + 2] << 32)
                      >> (x & 15)) & ((1 << sl) - 1)
                if ex:            # the bytes themselves
                    cs = [row[j + t] if j + t < L else 4 for t in range(sl)]
                    q = k = 0
                    for t, c in enumerate(cs[:left]):
                        q |= (c << (2 * t)) & M32
                    for t, c in enumerate(cs[left:]):
                        k |= (c << (2 * (hlen - 1 - t))) & M32
                    good = all(c < 4 for c in cs)
                else:
                    q = bits & ((1 << 2 * left) - 1)
                    k = _rev2((bits >> 2 * left) & ((1 << 2 * hlen) - 1),
                              hlen)
                    # a 4 sets the bit above its 2-bit field
                    q |= sum(1 << (2 * t + 2) for t in range(left)
                             if iv >> t & 1)
                    k |= sum(1 << (2 * (hlen - 1 - t) + 2)
                             for t in range(hlen) if iv >> (left + t) & 1)
                    good = iv == 0
                r = b * P + p
                qw[r, s] = np.int64(q & M32).astype(np.uint32).view(np.int32)
                num[r, s] = np.int64(k & M32).astype(np.uint32).view(np.int32)
                ok[r, s] = good
    return qw.astype(np.int32), num.astype(np.int32), ok


M32 = 0xFFFFFFFF


def _seed_codes(rng, B, L, exotic=False):
    """Reads of random bases with N codes and an N run, ragged lengths
    (the tail pad 4), the last one at full length so a seed ends at L;
    with `exotic`, one read of arbitrary int8 codes."""
    codes = np.full((B, L), 4, np.int8)
    for b in range(B):
        n = L if b == B - 1 else int(rng.integers(L // 2, L))
        codes[b, :n] = rng.integers(0, 4, n)
        codes[b, rng.integers(0, n, max(1, n // 40))] = 4
        s = int(rng.integers(0, n - 30))
        codes[b, s:s + 25] = 4
    if exotic:
        codes[0] = rng.integers(-128, 128, L)
    return codes


def _seed_cfgs(seed_len, hlen, L, B=3):
    kw = dict(B=B, L=L, seed_len=seed_len, gap_len=1, thres=30, hlen=hlen,
              n=1000, dollar_pos=3, accept_score=0.6, error_rate=0.1)
    return tpipe.MapperConfig(**kw), jpipe.MapperConfig(**kw)


@pytest.mark.parametrize("seed_len,hlen,L", [
    (20, 14, 256),        # left 6, one CTA a read
    (20, 14, 4000),       # left 6, a few phase rows a CTA
    (20, 14, 22000),      # left 6, slices of a row
    (6, 6, 256),          # left 0
    (6, 6, 8001)])        # left 0, slices of a row
def test_packed_seed_model_matches_plain_and_jax(seed_len, hlen, L):
    """The kernel's packed-code extraction gives the plain version's qw
    and JAX's _position_tables' qw, key and validity for every seed: N
    codes, N runs, codes past L (the padded copy's 4s), a seed ending at
    L and, in one read, codes outside 0-4 (the kernel's byte path)."""
    tc, jc = _seed_cfgs(seed_len, hlen, L)
    assert tc.left == seed_len - hlen
    codes = _seed_codes(np.random.default_rng(L + seed_len), 3, L,
                        exotic=L < 5000)
    qw, num, ok = model_packed_seeds(tc, codes)
    tq, tn, to = (tsv._by_phase(tc, a) for a in tsv._position_tables(
        tc, torch.from_numpy(codes)))
    jq, jn, jo = (np.asarray(jpipe._by_phase(jc, a)) for a in
                  jpipe._position_tables(jc, jnp.asarray(codes)))
    for got, port, jax_ in ((qw, tq, jq), (num, tn, jn), (ok, to, jo)):
        np.testing.assert_array_equal(got, port.numpy())
        np.testing.assert_array_equal(got, jax_)
    lens = torch.full((3,), L, dtype=torch.int32)
    idx = SimpleNamespace(lch=torch.zeros((4 ** hlen, 2), dtype=torch.int32),
                          c4=torch.zeros(4, dtype=torch.int32),
                          packed=torch.zeros(4, dtype=torch.int32),
                          occ_samp=torch.zeros((4, 4), dtype=torch.int32))
    np.testing.assert_array_equal(qw, tsv.seed_tables_plain(
        tc, idx, torch.from_numpy(codes), lens)[0].numpy())
    starts = tsv._seed_starts(tc, 3, "cpu").numpy()
    assert (starts + seed_len == L).any()          # a seed ends at L
    assert (starts + seed_len > L).any()           # seeds past L
    assert (~ok).any() and ok.any()
    n_p, ns, cpr, chunks = model_seed_part(tc)
    assert (cpr > 1) == (tc.max_seeds >= SEEDS_PER_CTA)


def _occ_at(idx, cfg, c, loc):
    """csrc/vote.cu::occ_at on Python integers."""
    wid, off = loc >> 4, loc & 15
    npw, nocc = idx.packed.shape[0], idx.occ_samp.shape[0]
    word = int(idx.packed[min(max(wid, 0), npw - 1)]) & M32
    pat = word ^ (c * 0x55555555)
    hit = ~pat & ~(pat >> 1) & 0x55555555
    cnt = bin(hit & (0x55555555 >> (2 * (15 - off)))).count("1")
    cnt -= (c == 0 and wid == cfg.dollar_pos >> 4
            and (cfg.dollar_pos & 15) <= off)
    return int(idx.occ_samp[min(max(wid, 0), nocc - 1), c]) + cnt


def model_wide_queue(cfg, idx, codes, lens):
    """(k12, cnt12, wide, kw, cw) by the kernel's schedule: each CTA's
    seeds in its threads' order (a thread's k-th seed at thread + 256k),
    the lch gather of each, a warp's wide seeds queued by ballot in lane
    order, then each queued seed LF-narrowed, `left` steps, last code
    first."""
    P, S, left, thres = cfg.phases, cfg.max_seeds, cfg.left, cfg.thres
    qw, num, ok = model_packed_seeds(cfg, codes)
    B = codes.shape[0]
    out = {k: np.zeros((B * P, S), np.int64)
           for k in ("k12", "cnt12", "wide", "kw", "cw")}
    H = idx.lch.shape[0]
    lch = idx.lch.numpy()
    for b in range(B):
        for p0, n_p, s0, ns in model_ctas(cfg):
            queue = []
            for k in range(SEEDS_PER_CTA // SEED_THREADS):
                for lane0 in range(0, SEED_THREADS, 32):    # warps
                    for lc in range(lane0 + k * SEED_THREADS,
                                    lane0 + 32 + k * SEED_THREADS):
                        if lc >= n_p * ns:
                            continue
                        p, s = p0 + lc // ns, s0 + lc % ns
                        r = b * P + p
                        kk, ll = (int(x) for x in lch[min(max(
                            int(num[r, s]), 0), H - 1)])
                        present = (ok[r, s] and p + cfg.step * s
                                   < int(lens[b]) - cfg.seed_len
                                   and not (kk == 0 and ll == 0))
                        cnt = min(ll - kk + 1, thres) if present else 0
                        wide = present and cnt >= thres
                        out["k12"][r, s], out["cnt12"][r, s] = kk, cnt
                        out["wide"][r, s] = wide
                        out["kw"][r, s] = kk
                        if wide:
                            queue.append((r, s, kk, ll, int(qw[r, s])))
            for r, s, kk, ll, q in queue:
                for t in range(left - 1, -1, -1):
                    if kk > ll:
                        break
                    c = (q >> (2 * t)) & 3
                    cb = int(idx.c4[c])
                    sk, sll = max(kk, 1), min(max(ll, 0),
                                              idx.occ_samp.shape[0] * 16 - 1)
                    kk = cb + _occ_at(idx, cfg, c, sk - 1) + 1
                    ll = cb + _occ_at(idx, cfg, c, sll)
                hits = ll - kk + 1 if kk <= ll else 0
                out["kw"][r, s] = kk
                out["cw"][r, s] = hits if 0 < hits < thres else 0
    return out


@pytest.mark.parametrize("L", [256, 4000])
def test_wide_queue_model_matches_plain_on_the_repeat(rep, L):
    """The repeat genome's wide seeds, queued and narrowed after each
    CTA's main pass, get the plain version's kw and cw; every other table
    equal too."""
    params = Params(hlen=HLEN, thres=30)
    tc = tpipe.MapperConfig.from_params(params, rep["tmeta"], 8, L)
    codes, lens = _chunk(rep, params, rep["reads"], 8, L, rep["tidx"],
                         rep["tmeta"])
    want = dict(zip(("qw", "k12", "cnt12", "wide", "kw", "cw"),
                    tsv.seed_tables_plain(tc, rep["tidx"],
                                          torch.from_numpy(codes),
                                          torch.from_numpy(lens))))
    got = model_wide_queue(tc, rep["tidx"], codes, lens)
    assert want["wide"].sum() > 0 and (want["cw"] > 0).any()
    for k, g in got.items():
        np.testing.assert_array_equal(g, want[k].numpy().astype(np.int64),
                                      err_msg=k)


# JAX in x64 mode (forced pos64 layouts) runs in a process of its own
POS64_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json
import numpy as np
from dataclasses import replace
from types import SimpleNamespace
from longreadmapper_tpu.index.device import load_device_index
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.oracle.refpipe import _Histo
from longreadmapper_tpu.utils.config import Params
from test_torch_seed_vote import jax_intermediates
fa, npz, out, cfg_json = sys.argv[2:6]
kw = json.loads(cfg_json)
slim = kw.pop("slim")
idx, meta, _ = load_device_index(fa, force_pos_dtype="int64", slim=slim)
assert meta.pos_dtype == "int64" and meta.slim == slim
params = Params(**kw.pop("params"))
B, L = kw.pop("B"), kw.pop("L")
jc = replace(jpipe.MapperConfig.from_params(params, meta, B, L), **kw)
d = np.load(npz)
np.savez(out, **jax_intermediates(jc, idx, d["codes"], d["lens"]))
"""


@pytest.mark.parametrize("case", ["full", "slim", "wide"])
def test_plain_seed_vote_matches_jax_pos64(e2e, rep, tmp_path, case):
    """The split-hi pos64 layouts (forced on the small genome): int64 k12,
    k_seed and key1 from the joined high bytes, against JAX in x64 mode;
    they equal the int32 layout's values widened."""
    d = rep if case == "wide" else e2e
    slim = case == "slim"
    pkw = (dict(hlen=HLEN, thres=30) if case == "wide"
           else dict(hlen=HLEN, seed_len=20, thres=300))
    params = Params(**pkw)
    reads = rep["reads"] if case == "wide" else _e2e_reads(e2e)
    B, L = (8 if case == "wide" else 16), 256
    args = (d["fmi"], d["kl"], HLEN, d["cat"], d["mta"])
    tidx, tmeta = tdevice.build_device_index(*args, "cpu",
                                             force_pos_dtype="int64",
                                             slim=slim)
    tc = tpipe.MapperConfig.from_params(params, tmeta, B, L)
    assert tc.pos64 and tc.slim == slim
    codes, lens = _chunk(d, params, reads, B, L, tidx, tmeta)
    np.savez(tmp_path / "in.npz", codes=codes, lens=lens)
    cfg = dict(slim=slim, params=pkw, B=B, L=L)
    r = subprocess.run([sys.executable, "-c", POS64_WORKER, ROOT, d["fa"],
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz"),
                        json.dumps(cfg)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    got = port_intermediates(tc, tidx, codes, lens)
    assert got["k12"].dtype == got["key1"].dtype == np.int64
    _compare(want, got)
    tc32 = tpipe.MapperConfig.from_params(params, d["tmeta"], B, L)
    if not slim:
        narrow = port_intermediates(tc32, d["tidx"], codes, lens)
        for k in ("k12", "k_seed", "key1", "v1", "v2", "total"):
            np.testing.assert_array_equal(got[k], narrow[k], err_msg=k)
