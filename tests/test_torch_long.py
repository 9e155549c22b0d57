"""The port's long-read `map` path on the CPU against the JAX package:
MapperConfig's long-read properties, the slot assignment of the seed vote
on long buckets (JAX takes its merge sort _slots_by_sort there), and
TorchMapper's SAM byte-identical to TPUMapper's on one case per long-read
tier: resident directions at the 3072 bucket (int16 run entries), one
~9.5 kb read at the 10240 bucket (int32 entries), the forced gact path with
the half-band retry, and the gact saturation tier.  One case departs from
TPUMapper on purpose: a 10240-bucket retry through gact, whose int16 run
entries the port widens to the chunk's int32 (ROADMAP.md section C)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import build_both, cigar_check
from conftest import write_fasta
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.models.mapper import TPUMapper
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.models.mapper import TorchMapper

torch.set_num_threads(1)
HLEN = 10
PROPS = ("B", "L", "W", "use_gact", "gact_W", "gact_band",
         "short_W", "short_band", "tb_entry_bytes", "max_seeds",
         "vote_slots", "vote_slots_exact", "exact_slots", "half_band",
         "short_W_override", "gact_tile", "gact_runs_scale")


@pytest.fixture(scope="module")
def g60(tmp_path_factory):
    """A 60 kb random genome indexed for both packages at hlen 10."""
    rng = np.random.default_rng(17)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 60000))
    fa = str(tmp_path_factory.mktemp("torch_long") / "g.fa")
    write_fasta(fa, [("c1", genome)])
    d = build_both(fa, HLEN)
    d["genome"] = genome
    return d


def _read(rng, genome, n, sub=0.03, n_indel=0, rc=False):
    p = int(rng.integers(0, len(genome) - n - 50))
    s = list(genome[p:p + n + 20])
    for _ in range(n_indel):
        k = int(rng.integers(5, len(s) - 5))
        if rng.random() < 0.5:
            del s[k]
        else:
            s.insert(k, "ACGT"[int(rng.integers(0, 4))])
    s = np.frombuffer("".join(s[:n]).encode(), np.uint8).copy()
    m = rng.random(n) < sub
    s[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(m.sum()))]
    s = s.tobytes().decode()
    if rc:
        s = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    return s


def _mappers(d, chunk_b):
    params = Params(hlen=HLEN)
    jm = TPUMapper(d["idx"], d["meta"], d["mta"], params, chunk_b=chunk_b)
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], params,
                     chunk_b=chunk_b, device="cpu")
    return jm, tm


def _same_sam(jm, tm, reads):
    want = list(jm.map_stream_sam(iter([reads])))
    got = list(tm.map_stream_sam(iter([reads])))
    assert got == want
    for name in ("retried_reads", "overflow_reads", "retried_sat_chunks"):
        assert getattr(tm, name) == getattr(jm, name), name
    return got[0]


@pytest.mark.parametrize("L", [3072, 10240, 50176])
def test_config_properties_match_jax(g60, L):
    """The primary, retry and saturation configs of each long bucket equal
    JAX's, on the 4 Mb bench genome's meta at --chunk-b 2048."""
    jmeta = replace(g60["meta"], n=8_000_001, hlen=14)
    tmeta = replace(g60["tmeta"], n=8_000_001, hlen=14)
    params = Params()
    jm = TPUMapper(g60["idx"], jmeta, g60["mta"], params, chunk_b=2048)
    tm = TorchMapper(g60["tidx"], tmeta, g60["mta"], params, chunk_b=2048,
                     device="cpu")
    tiers = [(jm._step_for(L)[0], tm._step_for(L)),
             (jm._retry_step_for(L)[0], tm._retry_step_for(L))]
    if tiers[0][0].use_gact:
        tiers.append((jm._sat_step_for(L)[0], tm._sat_step_for(L)))
    for jc, tc in tiers:
        for name in PROPS:
            assert getattr(tc, name) == getattr(jc, name), (L, name)
    # the long buckets at --chunk-b 2048: B, the first pass and the retry
    prim, retry = tiers[0][1], tiers[1][1]
    want = {3072: (680, False, 153, 384, 2, False, 640),
            10240: (200, False, 512, 1152, 4, True, 2176),
            50176: (40, True, 2508, 5120, 2, True, 10112)}[L]
    first = ((prim.gact_W, prim.gact_band) if prim.use_gact
             else (prim.short_W, prim.short_band))
    assert (prim.B, prim.use_gact) + first + (
        prim.tb_entry_bytes, retry.use_gact,
        retry.gact_band if retry.use_gact else retry.short_band) == want
    if L == 50176:
        assert (prim.phases, prim.max_seeds, prim.vote_slots) == (21, 2389,
                                                                  2592)


def _slot_inputs(rng, BP, S, C):
    """Per-seed vote counts with empty seeds and rows that overflow C."""
    cnt = rng.poisson(C / S * 0.9, (BP, S)).astype(np.int32)
    cnt[rng.random((BP, S)) < 0.2] = 0
    cnt[0] = rng.integers(2, 5, S)                      # overflows C
    k_seed = rng.integers(0, 1 << 20, (BP, S)).astype(np.int32)
    qw = rng.integers(0, 1 << 20, (BP, S)).astype(np.int32)
    j_ps = (np.arange(BP)[:, None] % 21 + 21 * np.arange(S)[None, :]
            ).astype(np.int32)
    wide = rng.random((BP, S)) < 0.05
    return cnt, k_seed, qw, j_ps, wide


@pytest.mark.parametrize("BP,S,C", [(42, 195, 256), (21, 488, 1152)])
def test_slots_by_owner_match_jax_slots_by_sort(g60, BP, S, C):
    """The port's owner gather gives JAX's merge-sort slot outputs (A7):
    equal totals and occupancy, equal (p_rank, qw, wide, j) on every
    occupied slot; empty slots carry j = -1 and wide = False on both."""
    rng = np.random.default_rng(C)
    args = _slot_inputs(rng, BP, S, C)
    jc = jpipe.MapperConfig.from_params(Params(hlen=HLEN), g60["meta"], 2,
                                        4096)
    want = jax.jit(lambda *a: jpipe._slots_by_sort(jc, *a, n_slots=C))(
        *(jnp.asarray(a) for a in args))
    got = tsv._slots_by_owner(C, *(torch.from_numpy(a) for a in args))
    p_w, qw_w, wide_w, j_w, tot_w = (np.asarray(a) for a in want[:5])
    p_g, qw_g, wide_g, j_g, tot_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(tot_g, tot_w)
    np.testing.assert_array_equal(j_g, j_w)
    np.testing.assert_array_equal(wide_g, wide_w)
    valid = j_w >= 0
    assert valid.any() and (~valid).any() and (tot_w > C).any()
    np.testing.assert_array_equal(p_g[valid], p_w[valid])
    np.testing.assert_array_equal(qw_g[valid], qw_w[valid])


def test_slots_by_owner_memory_at_50kb_shape():
    """At the 50 kb bucket's shape (B*P = 40*21 rows, S = 2389 seeds, C =
    2592 slots) no step allocates more than one (B*P, C) int64 array: the
    JAX owns matrix would be (B*P, S, C)."""
    from torch.profiler import ProfilerActivity, profile
    BP, S, C = 840, 2389, 2592
    args = _slot_inputs(np.random.default_rng(0), BP, S, C)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        tsv._slots_by_owner(C, *(torch.from_numpy(a) for a in args))
    ev = prof.events()
    assert max(e.cpu_memory_usage for e in ev) <= BP * C * 8
    assert sum(max(e.self_cpu_memory_usage, 0) for e in ev) <= 16 * BP * C * 8


def test_seed_vote_matches_jax_on_gact_config(g60):
    rng = np.random.default_rng(2)
    genome = g60["genome"]
    reads = [(f"s{i}", _read(rng, genome, 2600, n_indel=3, rc=i % 2), None)
             for i in range(6)]
    kw = dict(mid_dirs_budget=0, half_band=True, short_W_override=204)
    params = Params(hlen=HLEN)
    jc = replace(jpipe.MapperConfig.from_params(params, g60["meta"], 8,
                                                4096), **kw)
    tc = replace(tpipe.MapperConfig.from_params(params, g60["tmeta"], 8,
                                                4096), **kw)
    assert jc.use_gact and tc.use_gact
    tm = TorchMapper(g60["tidx"], g60["tmeta"], g60["mta"], params,
                     chunk_b=8, device="cpu")
    codes, _, lens, _ = tm._pack_reads(reads, 4096, 8)
    want = jax.jit(lambda i, c, l: jpipe._seed_vote(jc, i, c, l))(
        g60["idx"], jnp.asarray(codes), jnp.asarray(lens))
    got = tpipe._seed_vote(tc, g60["tidx"], torch.from_numpy(codes),
                           torch.from_numpy(lens))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sam_resident_3072_bucket_int16(g60):
    rng = np.random.default_rng(5)
    reads = [(f"m{i}", _read(rng, g60["genome"], 2500, n_indel=4, rc=i % 2),
              None) for i in range(6)]
    jm, tm = _mappers(g60, 8)
    cfg = tm._step_for(3072)
    assert (not cfg.use_gact and cfg.short_W < cfg.W
            and cfg.tb_entry_bytes == 2)
    text, total, valid = _same_sam(jm, tm, reads)
    assert total == 6 and valid == 6


def test_sam_resident_10240_bucket_int32(g60):
    """One ~9.5 kb read at the 10240 bucket (tests/test_gact.py's long-read
    case): resident directions at half band, int32 run entries."""
    rng = np.random.default_rng(10240)
    read = _read(rng, g60["genome"], 9500, sub=0.004, n_indel=3)
    jm, tm = _mappers(g60, 1)
    cfg = tm._step_for(10240)
    assert (cfg.B, cfg.use_gact, cfg.tb_entry_bytes) == (8, False, 4)
    text, total, valid = _same_sam(jm, tm, [("lr", read, None)])
    cigar = text.split("\t")[5]
    assert valid == 1 and ("I" in cigar or "D" in cigar)


def test_retry_widens_run_entries_10240(g60):
    """At the 10240 bucket the first pass is resident with int32 run
    entries and the full-band retry takes gact with int16 entries (a
    budget between their direction volumes, as B 200 meets the default
    one).  The retried row is widened to int32 before it is spliced in,
    so every CIGAR consumes its read and spells the record's ED."""
    rng = np.random.default_rng(9)
    genome = g60["genome"]
    reads = [("lo", _read(rng, genome, 9500, sub=0.004, n_indel=3), None),
             ("hi", _read(rng, genome, 9500, sub=0.09, n_indel=4, rc=True),
              None)]
    tm = TorchMapper(g60["tidx"], g60["tmeta"], g60["mta"],
                     Params(hlen=HLEN), chunk_b=2, device="cpu")
    tm._cfgs[10240] = cfg = replace(tm._step_for(10240),
                                    mid_dirs_budget=32 << 20)
    retry = tm._retry_step_for(10240)
    assert (cfg.use_gact, cfg.tb_entry_bytes, retry.use_gact,
            retry.tb_entry_bytes) == (False, 4, True, 2)
    text, total, valid = next(tm.map_stream_sam(iter([reads])))
    assert (total, valid, tm.retried_reads, tm.overflow_reads) == (2, 2, 1, 0)
    for rec in (line.split("\t") for line in text.splitlines()):
        assert cigar_check(rec, genome) == (len(rec[9]),
                                             int(rec[11][len("ED:I:"):]))


def _force_gact(tm, L):
    """A zero resident budget on the mapper's cached config of bucket L
    (its retry and saturation configs derive from it), as JAX's
    LRM_MID_DIRS_BUDGET=0 does; returns that config."""
    tm._cfgs[L] = replace(tm._step_for(L), mid_dirs_budget=0)
    assert tm._step_for(L).use_gact
    return tm._step_for(L)


def test_sam_gact_half_band_retry(g60, monkeypatch):
    """The gact path forced at the 3072 bucket (a zero resident budget):
    2.6 kb reads at ~8% error straddle the half band W/2, flag bit 2,
    re-run through the full-band tier and are spliced back."""
    rng = np.random.default_rng(31)
    reads = [(f"h{i}", _read(rng, g60["genome"], 2600, sub=0.08,
                             n_indel=2 * (i % 2)), None) for i in range(6)]
    monkeypatch.setenv("LRM_MID_DIRS_BUDGET", "0")
    jm, tm = _mappers(g60, 6)
    cfg = _force_gact(tm, 3072)
    assert cfg.half_band and cfg.gact_W == cfg.W // 2
    assert jm._step_for(3072)[0].use_gact
    assert tm._retry_step_for(3072).use_gact
    text, total, valid = _same_sam(jm, tm, reads)
    assert tm.retried_reads > 0 and tm.overflow_reads == 0
    assert valid >= 4


def _force_saturation(pending, to_numpy):
    """Set overflow bit 1 on every read of submitted parts: JAX's (cfg,
    reads, lens, out) tuples or the port's records."""
    for part in pending:
        cfg, blob = ((part[0], part[3]["blob"]) if isinstance(part, tuple)
                     else (part.cfg, part.first.blob))
        blob = to_numpy(blob)
        mw = 4 * (cfg.META_WORDS if hasattr(cfg, "META_WORDS")
                  else cfg.meta_words)
        meta = np.ascontiguousarray(blob[:, :mw]).view(np.int32)
        meta[:, -1] |= 2
        blob[:, :mw] = meta.view(np.int8)
        yield blob


def test_sam_gact_saturation_tier(g60, monkeypatch):
    """A gact chunk flagged with bit 1 re-runs through the 4x run-buffer
    tier on both mappers (tests/test_two_tier.py's forced flag) and comes
    back with the same records as the direct mapping."""
    rng = np.random.default_rng(23)
    reads = [(f"s{i}", _read(rng, g60["genome"], 2600, sub=0.02,
                             n_indel=3), None) for i in range(4)]
    monkeypatch.setenv("LRM_MID_DIRS_BUDGET", "0")
    jm, tm = _mappers(g60, 4)
    _force_gact(tm, 3072)
    base = [r.to_sam() for r in tm.map_chunk(reads)]
    assert base == [r.to_sam() for r in jm.map_chunk(reads)]

    pend_j = jm.submit_chunk(reads)
    blobs = list(_force_saturation(
        pend_j, lambda a: np.asarray(jax.device_get(a)).copy()))
    pend_j = [(c, r, l, dict(o, blob=jnp.asarray(b)))
              for (c, r, l, o), b in zip(pend_j, blobs)]
    pend_t = tm.submit_chunk(reads)
    list(_force_saturation(pend_t, lambda a: a.numpy()))   # in place
    got = [r.to_sam() for r in tm.collect_chunk(pend_t)]
    want = [r.to_sam() for r in jm.collect_chunk(pend_j)]
    assert got == want == base
    assert tm.retried_sat_chunks == jm.retried_sat_chunks == 1
    assert tm.overflow_reads == jm.overflow_reads == 0
