"""Shared fixtures of the port's parity tests (tests/test_torch_*.py): one
small index built once through the JAX package and handed to both
packages, so the JAX function and its PyTorch counterpart see the same
inputs.  The genome is the tests/test_e2e.py fixture (24 kb, two contigs,
1% N, hlen 6).  Imports neither JAX nor conftest at module level, so
the card-only tests can import it where JAX is absent."""

from __future__ import annotations

import re

import numpy as np
import torch

HLEN = 6


def torch_index(jidx, jmeta, device="cpu"):
    """The port's DeviceIndex/IndexMeta over np.asarray of each field of a
    JAX DeviceIndex."""
    from longreadmapper_tpu_torch.index.device import DeviceIndex, IndexMeta
    meta = IndexMeta(n=jmeta.n, dollar_pos=jmeta.dollar_pos, hlen=jmeta.hlen,
                     n_contigs=jmeta.n_contigs, pos_dtype=jmeta.pos_dtype,
                     slim=jmeta.slim)
    arrays = {k: (None if getattr(jidx, k) is None
                  else np.asarray(getattr(jidx, k)))
              for k in jidx._fields}
    return DeviceIndex.from_arrays(arrays, device), meta


def build_both(fa: str, hlen: int, lch: str = "sa"):
    """Index `fa` through the JAX package; return a dict with the host
    structures, the JAX (idx, meta) and the port's (tidx, tmeta)."""
    from longreadmapper_tpu.formats.catmeta import (create_meta, load_cat,
                                                    load_mta)
    from longreadmapper_tpu.formats.lch import write_lch
    from longreadmapper_tpu.index.device import build_device_index
    from longreadmapper_tpu.index.fmi import FMIndex, encode_bytes
    from longreadmapper_tpu.index.lchash import lc_build_from_sa
    from longreadmapper_tpu.index.sa import sa_build

    create_meta(fa, n_seed=0)
    prefix = fa + ".cat"
    sa = sa_build(prefix)
    fmi = FMIndex.build(prefix, sa=sa)
    fmi.write(prefix)
    cat = load_cat(prefix)
    kl = lc_build_from_sa(sa, encode_bytes(cat), hlen)
    write_lch(prefix + ".lch", hlen, kl)
    mta = load_mta(fa + ".mta")
    idx, meta = build_device_index(fmi, kl, hlen, cat, mta)
    tidx, tmeta = torch_index(idx, meta)
    return dict(fa=fa, fmi=fmi, kl=kl, cat=cat, mta=mta, idx=idx, meta=meta,
                tidx=tidx, tmeta=tmeta)


def e2e_fixture(tmp):
    """The tests/test_e2e.py genome, indexed for both packages."""
    from conftest import make_genome, write_fasta
    torch.set_num_threads(1)
    rng = np.random.default_rng(21)
    genome = make_genome(rng, 24000, n_frac=0.01)
    fa = str(tmp / "ref.fa")
    write_fasta(fa, [("chrA", genome[:16000]), ("chrB", genome[16000:])])
    d = build_both(fa, HLEN)
    d["chrA"] = d["cat"][:16000].tobytes().decode()
    d["chrB"] = d["cat"][32000:40000].tobytes().decode()
    return d


def repeat_fixture(tmp):
    """A wide-seed genome: a 60-mer tandem-repeated 40x between unique
    flanks (the tests/test_e2e.py repeat case), thres 30 makes its seeds
    wide."""
    from conftest import write_fasta
    torch.set_num_threads(1)
    rng = np.random.default_rng(77)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    motif = rand(60)
    genome = rand(8000) + motif * 40 + rand(8000)
    fa = str(tmp / "rep.fa")
    write_fasta(fa, [("rep", genome)])
    d = build_both(fa, HLEN)
    d["genome"] = genome
    reads = []
    for i, p in enumerate([7900, 7950, 2000, 4000, 8000 + 60 * 40 - 50,
                           12000]):
        ch = np.frombuffer(genome[p:p + 200].encode(), np.uint8).copy()
        m = rng.random(200) < 0.02
        ch[m] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(m.sum()))]
        reads.append((f"rep{i}", ch.tobytes().decode(), None))
    d["reads"] = reads
    return d


def mutate_rows(rng, q: np.ndarray, n_edits: int, pad: int = 0):
    """Target rows = q mutated by random substitutions and 1-base indels,
    cut/padded to the row length with 5; the last `pad` query columns are
    set to the pad code 4 (the realistic band-DP inputs of
    tests/test_band_pallas.py)."""
    B, L = q.shape
    t = np.full((B, L), 5, np.int8)
    for b in range(B):
        s = list(q[b, :L - pad])
        for _ in range(n_edits):
            k = rng.integers(0, 3)
            p = int(rng.integers(0, len(s)))
            if k == 0:
                s[p] = (s[p] + 1 + int(rng.integers(0, 3))) % 4
            elif k == 1 and len(s) > 4:
                del s[p]
            else:
                s.insert(p, int(rng.integers(0, 4)))
        s = s[:L]
        t[b, :len(s)] = s
    if pad:
        q[:, L - pad:] = 4
    return t


def cigar_check(rec, genome: str):
    """(query bases the record's CIGAR consumes, the edit distance of its
    alignment against the genome) for a mapped SAM record (split fields);
    lowercase read bases match, N matches nothing."""
    seq, ref = rec[9].upper(), genome[int(rec[3]) - 1:]
    qi = ri = ed = 0
    for n, op in re.findall(r"(\d+)([MID])", rec[5]):
        n = int(n)
        if op == "M":
            ed += sum(a != b for a, b in zip(seq[qi:qi + n], ref[ri:ri + n]))
        else:
            ed += n
        qi += n if op in "MI" else 0
        ri += n if op in "MD" else 0
    return qi, ed


def jax_flagged_reads(jm) -> set:
    """Spy on TPUMapper `jm`'s SAM assembly: the set it returns fills with
    the names of the reads whose final meta keeps bit 0 (the vote
    overflowed even JAX's exact tier, so JAX's vote is not the
    reference's)."""
    names = set()
    real = jm._postprocess_sam

    def spy(cfg, reads, lens, out, *a, **k):
        flag = out["meta"][:len(reads), cfg.meta_words - 1] & 1
        names.update(r[0] for r, f in zip(reads, flag) if f)
        return real(cfg, reads, lens, out, *a, **k)

    jm._postprocess_sam = spy
    return names


def assert_sam_matches_jax_or_oracle(got: str, want: str, flagged: set,
                                     oracle) -> int:
    """The port's SAM text `got` line by line against TPUMapper's `want`;
    a read JAX leaves flagged with bit 0 (`flagged`, jax_flagged_reads) is
    held to the oracle's (refpipe.OracleMapper) record instead.  Returns
    how many reads the oracle judged."""
    from longreadmapper_tpu.formats.sam import cigar_string
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    judged = 0
    for line, jline in zip(g, w):
        f = line.split("\t")
        assert f[0] == jline.split("\t")[0]
        if f[0] not in flagged:
            assert line == jline, f[0]
            continue
        judged += 1
        seq = (f[9] if int(f[1]) & 16 == 0 else
               f[9].translate(str.maketrans("ACGT", "TGCA"))[::-1])
        o = oracle.map_read(seq)
        assert (int(f[1]), f[2], int(f[3]), int(f[4])) == (
            o.flag, oracle.mta[o.gi].seq_name if o.found else "*",
            o.off + 1 if o.found else 1, o.mapq), f[0]
        assert f[5] == (cigar_string(o.cigar) if o.valid else "*"), f[0]
        assert (f[9], f[11]) == (o.seq_out, f"ED:I:{o.ed}"), f[0]
    return judged
