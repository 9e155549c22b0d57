"""The generator: the same seed gives the same genome and reads, lengths
stay inside their bounds, identities follow the read model, the genome
holds the repeat families where the configuration puts them, and reads
come from the genome as the error model says."""

import numpy as np
import pytest

from benchmark.traffic import (draw_identity, make_genome, make_pool,
                               rng_for, write_fasta)

from .conftest import TINY_CONFIG, TINY_TRAFFIC

BIG_SEED = 2**31 + 12345


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_same_seed_same_inputs(seed):
    g1 = make_genome(TINY_CONFIG["genome"], seed)
    g2 = make_genome(TINY_CONFIG["genome"], seed)
    assert np.array_equal(g1.codes, g2.codes)
    p1, p2 = make_pool(g1, TINY_TRAFFIC, seed), make_pool(g2, TINY_TRAFFIC,
                                                         seed)
    assert p1.seqs == p2.seqs and p1.quals == p2.quals
    assert np.array_equal(p1.lengths, p2.lengths)
    g3 = make_genome(TINY_CONFIG["genome"], seed + 1)
    assert not np.array_equal(g1.codes, g3.codes)
    assert make_pool(g3, TINY_TRAFFIC, seed + 1).seqs != p1.seqs


@pytest.mark.parametrize("lo,hi", [(2049, 3072), (8193, 10240),
                                   (49153, 50176)])
def test_lengths_stay_in_bounds(lo, hi):
    g = make_genome({"contigs": [["c", 200000]]}, 3)
    lengths = dict(TINY_TRAFFIC["lengths"], min=lo, max=hi)
    p = make_pool(g, dict(TINY_TRAFFIC, lengths=lengths, pool_chunks=8), 3)
    assert len(p.seqs) == 8 * TINY_TRAFFIC["chunk_reads"]
    assert all(lo <= len(s) <= hi for s in p.seqs)
    assert [len(s) for s in p.seqs] == p.lengths.tolist()
    assert all(set(s) <= set("ACGT") for s in p.seqs)
    assert [len(q) for q in p.quals] == p.lengths.tolist()
    # the share below the bucket's middle is the gamma density's there
    many = make_pool(g, dict(TINY_TRAFFIC, lengths=lengths,
                             pool_chunks=250), 4).lengths
    k = (15000 / 13000) ** 2
    theta = 13000 ** 2 / 15000
    x = np.arange(lo, hi + 1)
    dens = x ** (k - 1) * np.exp(-(x - lo) / theta)
    mid = (lo + hi) / 2
    want = dens[x < mid].sum() / dens.sum()
    assert abs((many < mid).mean() - want) < 0.03


def test_identity_draws_and_chunks():
    spec = TINY_TRAFFIC["identity"]
    x = draw_identity(rng_for(1, 2), spec, 200000)
    assert x.max() <= spec["max"]
    assert abs(x.mean() - spec["mean"]) < 0.001
    assert abs(x.std() - spec["stdev"]) < 0.001
    g = make_genome(TINY_CONFIG["genome"], 5)
    p = make_pool(g, TINY_TRAFFIC, 5)
    assert p.identity.shape == (len(p.seqs),)
    assert p.n_chunks == TINY_TRAFFIC["pool_chunks"]
    assert list(p.chunk(1)) == list(range(8, 16))


def test_repeat_families_where_the_configuration_puts_them():
    g = make_genome(TINY_CONFIG["genome"], 6)
    text = "".join("ACGT"[c] for c in g.codes)
    c1, c2 = text[:40000], text[40000:]
    fams = {f["family"]: f for f in TINY_CONFIG["genome"]["repeats"]}
    # the tandem: two copies head to tail at its place
    unit = c1[20000:23500]
    assert c1[23500:27000] == unit
    # each family's copies are identical, in either orientation
    rc = str.maketrans("ACGT", "TGCA")

    def copies(seq):
        back = seq.translate(rc)[::-1]
        return sum(text.count(x) for x in {seq, back})

    assert copies(unit) == 2
    ends = [c1[:1200], c1[-1200:], c2[:1200], c2[-1200:]]
    held = [e for e in ends if copies(e) == fams["end"]["copies"]]
    assert len(held) == fams["end"]["copies"]
    # the background holds the GC share asked for
    gc = (g.codes == 1) | (g.codes == 2)
    assert abs(gc.mean() - 0.45) < 0.01


def test_error_free_reads_are_genome_windows():
    g = make_genome(TINY_CONFIG["genome"], 9)
    text = "".join("ACGT"[c] for c in g.codes)
    contigs = [text[o:o + n] for o, n in zip(g.offsets, g.lengths)]
    clean = dict(TINY_TRAFFIC, errors={"sub": 0.0, "ins": 0.0, "dele": 0.0})
    p = make_pool(g, clean, 9)
    for s in p.seqs:
        assert any(s in c or _rc(s) in c for c in contigs)


def test_error_rates_match_the_mix():
    g = make_genome({"contigs": [["c", 400000]]}, 11)
    mix = dict(TINY_TRAFFIC, pool_chunks=20, reverse_share=0.0,
               identity={"mean": 0.95, "max": 0.99, "stdev": 0.002},
               errors={"sub": 1.0, "ins": 0.0, "dele": 0.0})
    p = make_pool(g, mix, 11)
    text = "".join("ACGT"[c] for c in g.codes)
    # substitutions only: each read lies on the genome base for base, at
    # the place an error-free 24-mer of it finds
    diffs = []
    for s in p.seqs[:60]:
        for k in range(0, len(s) - 24, 24):
            at = text.find(s[k:k + 24])
            if at >= k:
                ref = text[at - k:at - k + len(s)]
                diffs.append(sum(a != b for a, b in zip(s, ref)) / len(s))
                break
    assert len(diffs) > 50
    assert abs(float(np.mean(diffs)) - 0.05) < 0.005


def test_fasta_holds_the_genome(tmp_path):
    g = make_genome({"contigs": [["a", 1000], ["b", 81], ["c", 80]]}, 2)
    path = str(tmp_path / "g.fa")
    write_fasta(path, g)
    seqs, name = {}, None
    for line in open(path).read().splitlines():
        if line.startswith(">"):
            name = line[1:]
            seqs[name] = ""
        else:
            assert len(line) <= 80
            seqs[name] += line
    text = "".join("ACGT"[c] for c in g.codes)
    assert seqs == {"a": text[:1000], "b": text[1000:1081],
                    "c": text[1081:1161]}
