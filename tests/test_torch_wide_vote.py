"""The exact vote tier sized by each read's real occurrences, on the CPU.

A read whose vote overflows the compact tier (bit 0) and whose widest
(read, phase) row passes the exact tier's slots takes a wide vote class
step (TorchMapper._retry_overflow): one config a power-of-2 class of
slots, sized by the first pass's vote_need.  On a seeded genome with 40
copies of a 2 kb family (reads of 2,049-3,072 bases, the 3072 bucket,
whose exact tier has 384 slots) the port's records equal the reference
transcription's (refpipe.OracleMapper) and the benchmark's plain
reference's (benchmark/reference.py), no read keeps a flag, and reads
take the classes; with 4 copies of 1.2 kb none does.  vote_need against
a count of each seed's occurrences in the text, vote_classes against the
least power of 2 found by doubling, and the vote at a class against the
plain vote at a wider row."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_parity import build_both
from benchmark.reference import Reference
from benchmark.traffic import make_genome, make_pool, write_fasta
from longreadmapper_tpu.formats.sam import cigar_string
from longreadmapper_tpu.oracle.refpipe import OracleMapper
from longreadmapper_tpu.utils.config import Params as JParams
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)
HLEN = 10
TRAFFIC = {"lengths": {"mean": 15000, "stdev": 13000, "min": 2049,
                       "max": 3072},
           "identity": {"mean": 0.95, "max": 0.99, "stdev": 0.025},
           "errors": {"sub": 1 / 3, "ins": 1 / 3, "dele": 1 / 3},
           "chunk_reads": 16, "pool_chunks": 3, "reverse_share": 0.5,
           "qual": "I"}


def _family(copies: int, length: int, seed: int, tmp):
    """Two contigs (90 and 80 kb) holding `copies` copies of one family,
    indexed for both packages at hlen 10, with 48 reads in 3 chunks."""
    g = make_genome({"contigs": [["c1", 90000], ["c2", 80000]], "gc": 0.4,
                     "repeats": [{"family": "fam", "length": length,
                                  "copies": copies,
                                  "placement": "scattered"}]}, seed)
    fa = str(tmp / "g.fa")
    write_fasta(fa, g)
    d = build_both(fa, HLEN)
    pool = make_pool(g, TRAFFIC, seed, "cpu")
    d["genome"] = g
    d["chunks"] = [[(f"r{i}", pool.seqs[i], pool.quals[i])
                    for i in pool.chunk(k)] for k in range(pool.n_chunks)]
    return d


@pytest.fixture(scope="module")
def fam40(tmp_path_factory):
    return _family(40, 2000, 7, tmp_path_factory.mktemp("wide40"))


@pytest.fixture(scope="module")
def fam4(tmp_path_factory):
    return _family(4, 1200, 8, tmp_path_factory.mktemp("wide4"))


def _stream(d):
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], Params(hlen=HLEN),
                     chunk_b=16, device="cpu")
    recs = [r for c in tm.map_stream(iter(d["chunks"])) for r in c]
    return tm, recs


def _against_reference(d, recs):
    """Each record's vote (found, contig, strand, offset) and distance
    against benchmark/reference.py's."""
    reads = [s for c in d["chunks"] for _, s, _ in c]
    ref = Reference(d["genome"], 20, 300, "cpu")
    for rec, seq, e in zip(recs, reads, ref.map_reads(reads)):
        assert (rec.rname != "*") == e.found, rec.qname
        if e.found:
            assert (rec.rname, rec.off) == (d["genome"].names[e.gi],
                                            e.off), rec.qname
            assert (rec.seq != seq) == bool(e.strand), rec.qname
        assert (rec.valid, rec.ed) == (e.valid, e.ed), rec.qname


def test_port_maps_high_copy_family_as_the_oracle(fam40):
    """40 copies of 2 kb: the compact and the exact tier overflow for the
    reads over a copy; the wide classes re-vote them, and every record
    equals OracleMapper's and the plain reference's."""
    d = fam40
    tm, recs = _stream(d)
    assert tm._step_for(3072).L == 3072
    assert tm._retry_step_for(3072).vote_slots == 384
    assert tm.wide_vote_reads > 0 and tm.wide_vote_steps > 0
    assert tm.wide_vote_unresolved == 0 and tm.overflow_reads == 0
    oracle = OracleMapper(d["fmi"], d["kl"], HLEN, d["cat"], d["mta"],
                          JParams(hlen=HLEN))
    reads = [c for ch in d["chunks"] for c in ch]
    for (name, seq, _), rec in zip(reads, recs):
        o = oracle.map_read(seq)
        assert (rec.valid, rec.flag, rec.ed, rec.seq) == (
            o.valid, o.flag, o.ed, o.seq_out), name
        assert rec.rname == (d["mta"][o.gi].seq_name if o.found else "*")
        if o.found:
            assert rec.off == o.off, name
        if o.valid:
            assert rec.cigar == cigar_string(o.cigar), name
    _against_reference(d, recs)


def test_four_copies_take_no_class_step(fam4):
    d = fam4
    tm, recs = _stream(d)
    assert tm.wide_vote_reads == tm.wide_vote_steps == 0
    assert tm.overflow_reads == 0
    _against_reference(d, recs)


def _occurrences(text: str, kmer: str) -> int:
    n, at = 0, text.find(kmer)
    while at >= 0:
        n += 1
        at = text.find(kmer, at + 1)
    return n


def test_vote_need_is_each_reads_widest_row(fam40):
    """vote_need against a count of every seed's occurrences in the .cat
    text: a seed counts its hlen-mer's occurrences when fewer than thres,
    else its seed_len-mer's when those are fewer than thres, else none;
    a row sums its seeds, a read takes its widest row."""
    d = fam40
    text = d["cat"].tobytes().decode()
    reads = [s for _, s, _ in d["chunks"][0][:4]]
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], Params(hlen=HLEN),
                     chunk_b=16, device="cpu")
    cfg = tm._step_for(3072)
    codes, _, lens, _ = tm._pack_reads([("r", s, None) for s in reads],
                                       cfg.L, cfg.B)
    tabs = tsv.seed_tables(cfg, d["tidx"], torch.from_numpy(codes),
                           torch.from_numpy(lens))
    need = tsv.vote_need(cfg, tabs)[:len(reads)].tolist()
    sl, thres = cfg.seed_len, cfg.thres
    for r, s in enumerate(reads):
        rows = []
        for p in range(cfg.phases):
            total = 0
            for j in range(p, len(s) - sl, cfg.step):
                seed = s[j:j + sl]
                h = _occurrences(text, seed[sl - HLEN:])
                if h < thres:
                    total += h
                else:
                    w = _occurrences(text, seed)
                    total += w if w < thres else 0
            rows.append(total)
        assert need[r] == max(rows), r
    assert max(need) > tm._retry_step_for(3072).vote_slots


def test_vote_classes_against_doubling():
    rng = np.random.default_rng(3)
    need = np.concatenate([rng.integers(0, 200000, 200),
                           [0, 1, 383, 384, 385, 511, 512, 513, 4096,
                            4097, 145613, 262144]])
    got = tpipe.vote_classes(need, 384)
    for n, c in zip(need.tolist(), got.tolist()):
        want = 0
        if n > 384:
            want = 1
            while want < n:
                want *= 2
        assert c == want, n


def test_vote_at_a_wide_class_equals_a_wider_plain_vote(fam40):
    """vote_rows at the batch's widest class (its rows hold every vote)
    against vote_rows_plain at twice its width: the same top-2 and total
    of every row, and no overflow."""
    d = fam40
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], Params(hlen=HLEN),
                     chunk_b=16, device="cpu")
    cfg = tm._retry_step_for(3072)
    reads = [r for c in d["chunks"] for r in c][:cfg.B]
    codes, _, lens, _ = tm._pack_reads(reads, cfg.L, cfg.B)
    codes, lens = torch.from_numpy(codes), torch.from_numpy(lens)
    tabs = tsv.seed_tables(cfg, d["tidx"], codes, lens)
    need = tsv.vote_need(cfg, tabs)
    slots = int(tpipe.vote_classes([int(need.max())], cfg.vote_slots)[0])
    assert slots > cfg.vote_slots
    wide = tm._wide_step_for(3072, slots, cfg.B)
    assert wide.vote_slots == slots and wide.use_gact == cfg.use_gact
    rank = tsv.wide_rank(tabs[3])
    best, overflow, rows = tsv.vote_rows(wide, d["tidx"], lens, tabs, rank)
    wider = replace(wide, vote_budget=2 * slots)
    assert wider.vote_slots == 2 * slots <= cfg.vote_slots_max
    k_seed, cnt, wovf = tsv.pick_wide_seeds(wider, tabs[3], tabs[1],
                                            tabs[2], tabs[4], tabs[5], rank)
    want = tsv.vote_rows_plain(wider, d["tidx"], k_seed, cnt, tabs[0],
                               tabs[3])
    assert not wovf.any() and not overflow.any()
    assert (want[3] <= slots).all() and (want[3] > cfg.vote_slots).any()
    for g, w in zip(rows[:4], want):
        assert torch.equal(g, w)
