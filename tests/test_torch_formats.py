"""The port's own copies of the JAX package's host modules
(longreadmapper_tpu_torch/formats, /utils and csrc/sais.cpp) against the
originals: writers give byte-identical files (the streamed .sa5 writer
too), each reader reads the other
package's files, the parsers and SAM writers agree on fixed inputs, and the
port's SA-IS equals longreadmapper_tpu.native.suffix_array."""

import gzip
import os

import numpy as np
import pytest

from conftest import make_genome, write_fasta

import longreadmapper_tpu.formats.catmeta as j_catmeta
import longreadmapper_tpu.formats.fastx as j_fastx
import longreadmapper_tpu.formats.lch as j_lch
import longreadmapper_tpu.formats.mfi as j_mfi
import longreadmapper_tpu.formats.sam as j_sam
import longreadmapper_tpu.formats.ui40 as j_ui40
import longreadmapper_tpu.utils.config as j_config
import longreadmapper_tpu.utils.rng as j_rng
import longreadmapper_tpu_torch.formats.catmeta as t_catmeta
import longreadmapper_tpu_torch.formats.fastx as t_fastx
import longreadmapper_tpu_torch.formats.lch as t_lch
import longreadmapper_tpu_torch.formats.mfi as t_mfi
import longreadmapper_tpu_torch.formats.sam as t_sam
import longreadmapper_tpu_torch.formats.ui40 as t_ui40
import longreadmapper_tpu_torch.utils.config as t_config
import longreadmapper_tpu_torch.utils.rng as t_rng

PKGS = {"jax": (j_catmeta, j_lch, j_mfi, j_ui40),
        "torch": (t_catmeta, t_lch, t_mfi, t_ui40)}


def _mfi_data(mod, rng):
    n = 1000
    return mod.MfiData(
        c=rng.integers(0, 1 << 40, 256).astype(np.uint64), o_ratio=32,
        o=rng.integers(0, 1 << 40, 4 * (n // 32 + 1)).astype(np.uint64),
        bwt=rng.integers(0, 256, n).astype(np.uint8), csa_ratio=4,
        csa=rng.integers(0, 1 << 36, n // 4 + 1).astype(np.uint64))


def _fasta(d):
    rng = np.random.default_rng(5)
    g = make_genome(rng, 3000, n_frac=0.05)
    g = g[:1000] + g[1000:1500].lower() + "N" * 40 + g[1540:]
    fa = os.path.join(d, "g.fa")
    write_fasta(fa, [("chrA desc", g[:1900]), ("chrB", g[1900:])])
    return fa


def _write(kind, pkg, d):
    """Write one artifact of `kind` with package `pkg` into d; returns the
    paths written (the same inputs for both packages)."""
    catmeta, lch, mfi, ui40 = PKGS[pkg]
    rng = np.random.default_rng(3)
    if kind == "sa5":
        sa = rng.integers(0, 1 << 39, 3001).astype(np.int64)
        sa[:3] = [0, (1 << 32) - 1, 1 << 32]
        ui40.write_sa5(sa, os.path.join(d, "x.sa5"), chunk=1000)
        return [os.path.join(d, "x.sa5")]
    if kind == "sa5_stream":     # Sa5Writer, in uneven batches
        sa = rng.integers(0, 1 << 39, 3001).astype(np.int64)
        sa[:3] = [0, (1 << 32) - 1, 1 << 32]
        with ui40.Sa5Writer(os.path.join(d, "x.sa5")) as w:
            for s, e in ((0, 1), (1, 1), (1, 1000), (1000, 3001)):
                w.append(sa[s:e])
        return [os.path.join(d, "x.sa5")]
    if kind == "mfi":
        mfi.write_mfi(_mfi_data(mfi, rng), os.path.join(d, "x"))
        return [os.path.join(d, "x.mfi")]
    if kind == "lch":
        kl = rng.integers(0, 1 << 33, (1 << 6, 2)).astype(np.uint64)
        lch.write_lch(os.path.join(d, "x.lch"), 3, kl)
        return [os.path.join(d, "x.lch")]
    fa = _fasta(d)
    catmeta.create_meta(fa, n_seed=7)
    return [fa + ".mta", fa + ".cat"]


def _read(kind, pkg, paths):
    """Read what _write wrote with package `pkg`; as comparable numpy /
    tuple values."""
    catmeta, lch, mfi, ui40 = PKGS[pkg]
    if kind in ("sa5", "sa5_stream"):
        return [ui40.read_sa5(paths[0]), ui40.read_sa5(paths[0], count=5)]
    if kind == "mfi":
        m = mfi.read_mfi(paths[0][:-4])
        return [m.c, m.o, m.bwt, m.csa, np.array([m.o_ratio, m.csa_ratio,
                                                  m.length])]
    if kind == "lch":
        hlen, kl = lch.read_lch(paths[0])
        return [np.array([hlen]), kl]
    mta = [(m.seq_name, m.offset, m.seq_len)
           for m in catmeta.load_mta(paths[0])]
    return [np.array(mta, dtype=object), catmeta.load_cat(paths[1])]


KINDS = ["sa5", "sa5_stream", "mfi", "lch", "meta"]


@pytest.mark.parametrize("kind", KINDS)
def test_writers_give_byte_identical_files(tmp_path, kind):
    out = {}
    for pkg in PKGS:
        os.makedirs(tmp_path / pkg)
        out[pkg] = [open(p, "rb").read()
                    for p in _write(kind, pkg, str(tmp_path / pkg))]
    assert out["jax"] == out["torch"]
    assert all(len(b) > 0 for b in out["torch"])
    if kind == "sa5_stream":     # the stream writes what write_sa5 writes
        os.makedirs(tmp_path / "whole")
        whole = _write("sa5", "torch", str(tmp_path / "whole"))
        assert out["torch"] == [open(whole[0], "rb").read()]
        assert os.listdir(tmp_path / "torch") == ["x.sa5"]   # no .tmp


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", KINDS)
def test_readers_read_each_others_files(tmp_path, kind, writer):
    paths = _write(kind, writer, str(tmp_path))
    want = _read(kind, writer, paths)
    got = _read(kind, "torch" if writer == "jax" else "jax", paths)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_create_meta_entries_agree(tmp_path):
    fa = _fasta(str(tmp_path))
    want = j_catmeta.create_meta(fa, n_seed=3)
    got = t_catmeta.create_meta(fa, n_seed=3)
    assert [(m.seq_name, m.offset, m.seq_len) for m in got] == \
        [(m.seq_name, m.offset, m.seq_len) for m in want] == \
        [("chrA", 0, 1900), ("chrB", 3800, 1100)]


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fastq.gz"])
def test_read_fastx_agrees(tmp_path, kind):
    path = str(tmp_path / f"r.{kind}")
    if kind == "fasta":
        text = (">r1 first read\nACGTN\nacgt\n\n>r2\nGGGG\n>\nA\n"
                "garbage\n>r3\n")
    else:
        text = ("@q1 x\nACGT\nAC\n+\nIIII\nII\n@q2\nTTTT\n+q2\n!!!!\n"
                "@q3\nAAAAAA\n+\nIII\n")
    data = text.encode()
    if kind.endswith(".gz"):
        data = gzip.compress(data)
    with open(path, "wb") as f:
        f.write(data)
    want = [(r.name, r.seq, r.qual, len(r))
            for r in j_fastx.read_fastx(path)]
    got = [(r.name, r.seq, r.qual, len(r))
           for r in t_fastx.read_fastx(path)]
    assert got == want and len(got) >= 3


def test_encode_lut_agrees():
    np.testing.assert_array_equal(t_fastx._encode_lut(),
                                  j_fastx._encode_lut())


@pytest.mark.parametrize("fn", ["cigar_string", "sam_record", "sam_header"])
def test_sam_writers_agree(fn):
    args = {
        "cigar_string": [([],), ([(12, "M"), (1, "I"), (3, "D"),
                                 (40, "M")],)],
        "sam_record": [("r1", 0, "chrA", 0, 255, "150M", "ACGT", "IIII", 0),
                       ("r2", 16, "chrB", 99, 255, "3M1I", "TT", "*", 2),
                       ("r3", 4, "*", 0, 0, "*", "A", "*", -1)],
        "sam_header": [([t_catmeta.MtaEntry("chrA", 0, 1900),
                         t_catmeta.MtaEntry("chrB", 3800, 1100)], 0),
                       ([j_catmeta.MtaEntry("c", 0, 7)], 1712345678)],
    }[fn]
    for a in args:
        assert getattr(t_sam, fn)(*a) == getattr(j_sam, fn)(*a)


@pytest.mark.parametrize("case", ["params", "auto_hlen", "read_params",
                                  "rng"])
def test_utils_agree(tmp_path, case):
    if case == "params":
        assert t_config.Params().__dict__ == j_config.Params().__dict__
        kw = dict(hlen=6, seed_len=18, thres=40, batch_size=9)
        assert t_config.Params(**kw).__dict__ == \
            j_config.Params(**kw).__dict__
    elif case == "auto_hlen":
        for n in (0, 1, 1_999_999, 2_000_000, 10**10):
            assert t_config.auto_hlen(n) == j_config.auto_hlen(n)
    elif case == "read_params":
        missing = str(tmp_path / "none")
        assert t_config.read_params(missing).__dict__ == \
            j_config.read_params(missing).__dict__
        p = tmp_path / "params"
        p.write_text("64 18\n 40\n")
        assert t_config.read_params(str(p)).__dict__ == \
            j_config.read_params(str(p)).__dict__
        assert t_config.read_params(str(p)).thres == 40
    else:
        seq = np.frombuffer(b"ACNNNNnnGTN" * 40, np.uint8)
        a = j_rng.replace_n(seq, j_rng.Lcg48(11))
        b = t_rng.replace_n(seq, t_rng.Lcg48(11))
        np.testing.assert_array_equal(a, b)
        ja, ta = j_rng.Lcg48(2), t_rng.Lcg48(2)
        assert [ja.lrand48() for _ in range(9)] == \
            [ta.lrand48() for _ in range(9)]


def _sa_text(case: str) -> np.ndarray:
    rng = np.random.default_rng(["tiny", "cat", "n_runs", "repeat",
                                 "all_bytes"].index(case))
    if case == "tiny":
        return np.frombuffer(b"A", np.uint8).copy()
    if case == "repeat":
        return np.frombuffer(b"ACA" * 700 + b"A" * 500 + b"$", np.uint8).copy()
    if case == "all_bytes":
        return rng.integers(0, 256, 6000).astype(np.uint8)
    n = 4000 if case == "cat" else 30000
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    if case == "n_runs":
        for s in rng.integers(0, n - 200, 12):
            text[s:s + int(rng.integers(1, 200))] = ord("N")
    text[-1] = ord("$")
    return text


@pytest.mark.parametrize("case", ["tiny", "cat", "n_runs", "repeat",
                                  "all_bytes"])
def test_sais_matches_native(case):
    from longreadmapper_tpu import native
    from longreadmapper_tpu_torch.index.sa import suffix_array
    text = _sa_text(case)
    got = suffix_array(text)
    want = native.suffix_array(text)
    assert got.dtype == np.int64 and got.shape == text.shape
    np.testing.assert_array_equal(got, want)
