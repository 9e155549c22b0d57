"""The port's FM-index queries and host index helpers against the JAX
package on the same `.mfi` / `.sa5` (written by the JAX build, read by
each package's FMIndex.read): occ_access, fmi_aln (also against a naive
scan of the text, from a given interval, on an absent pattern and on N),
sa_access, csa_access (with its '$' return and bail-out), the full rank
table, lc_build_host (byte-equal to JAX's, to the port's lc_build_from_sa
and to lc_build_device on a DeviceIndex on the CPU), the lc_aln ==
fmi_aln invariant of the reference's test-lchash.cc, and sa_load."""

import numpy as np
import pytest
import torch

from conftest import make_genome, write_fasta
from longreadmapper_tpu.formats.catmeta import create_meta, load_cat
from longreadmapper_tpu.index.fmi import FMIndex as JFMIndex
from longreadmapper_tpu.index.lchash import lc_build_host as j_lc_build_host
from longreadmapper_tpu.index.sa import sa_build, sa_load as j_sa_load
from longreadmapper_tpu_torch.index.device import DeviceIndex, bwt_arrays
from longreadmapper_tpu_torch.index.fmi import FMIndex, encode_bytes
from longreadmapper_tpu_torch.index.lchash import (lc_build_device,
                                                   lc_build_from_sa,
                                                   lc_build_host)
from longreadmapper_tpu_torch.index.sa import sa_load

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fm(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fmi")
    rng = np.random.default_rng(7)
    g = make_genome(rng, 6000, n_frac=0.01)
    fa = str(tmp / "g.fa")
    write_fasta(fa, [("a", g[:3500]), ("b", g[3500:])])
    create_meta(fa, n_seed=1)
    prefix = fa + ".cat"
    JFMIndex.build(prefix, o_ratio=32, csa_ratio=4,
                   sa=sa_build(prefix)).write(prefix)
    return dict(prefix=prefix, cat=load_cat(prefix),
                port=FMIndex.read(prefix), jax=JFMIndex.read(prefix))


def _naive(cat: np.ndarray, pattern: bytes):
    s, out = cat.tobytes(), []
    i = s.find(pattern)
    while i >= 0:
        out.append(i)
        i = s.find(pattern, i + 1)
    return out


def test_full_rank_and_occ_access_match_jax(fm):
    port, jax = fm["port"], fm["jax"]
    assert port._rank is None
    np.testing.assert_array_equal(port._full_rank(), jax._full_rank())
    assert port._full_rank() is port._rank           # built once, kept
    rng = np.random.default_rng(1)
    n = port.length
    loc = np.concatenate([[-1, 0, n - 1], rng.integers(-1, n, 500)])
    code = rng.integers(0, 4, loc.shape[0])
    got = port.occ_access(code, loc)
    np.testing.assert_array_equal(got, jax.occ_access(code, loc))
    assert got[0] == 0
    for c in range(4):
        assert int(port.occ_access(c, n - 1)) == int(
            np.count_nonzero(encode_bytes(port.bwt) == c))


def test_fmi_aln_matches_jax_and_naive(fm):
    cat, port, jax = fm["cat"], fm["port"], fm["jax"]
    rng = np.random.default_rng(2)
    n, checked = len(cat), 0
    for _ in range(60):
        qlen = int(rng.integers(3, 30))
        start = int(rng.integers(0, n - 1 - qlen))
        pattern = cat[start:start + qlen].tobytes()
        codes = encode_bytes(np.frombuffer(pattern, np.uint8))
        hits, k, l = port.fmi_aln(codes)
        assert (hits, k, l) == jax.fmi_aln(codes)
        if b"$" in pattern:
            continue
        expect = sorted(_naive(cat, pattern))
        assert hits == len(expect)
        assert sorted(int(port.sa_access(i)) for i in range(k, l + 1)) \
            == expect
        checked += 1
    assert checked > 50


def test_fmi_aln_from_interval_matches_jax(fm):
    """The backward search continued from a (k, l) interval, as lc_aln
    continues it from a table entry."""
    cat, port, jax = fm["cat"], fm["port"], fm["jax"]
    rng = np.random.default_rng(3)
    for _ in range(30):
        start = int(rng.integers(0, len(cat) - 40))
        codes = encode_bytes(cat[start:start + 20])
        _, k, l = port.fmi_aln(codes[10:])
        assert port.fmi_aln(codes[:10], k, l) == jax.fmi_aln(codes[:10], k, l)
        assert port.fmi_aln(codes[:10], k, l)[0] == port.fmi_aln(codes)[0]


@pytest.mark.parametrize("case", ["absent", "n_first", "n_last", "n_only",
                                  "empty"])
def test_fmi_aln_absent_and_n_match_jax(fm, case):
    port, jax, cat = fm["port"], fm["jax"], fm["cat"]
    if case == "absent":
        q = encode_bytes(np.frombuffer(b"ACGT" * 10, np.uint8))
    elif case == "empty":
        q = np.zeros(0, np.uint8)
    else:
        q = encode_bytes(cat[100:120]).copy()
        q[{"n_first": 0, "n_last": -1, "n_only": slice(None)}[case]] = 4
    got = port.fmi_aln(q)
    assert got == jax.fmi_aln(q)
    if case == "absent":
        assert got[0] == len(_naive(cat, b"ACGT" * 10)) == 0
    elif case == "empty":
        assert got == (port.length - 1, 1, port.length - 1)
    else:
        assert got[0] == 0


def test_sa_and_csa_access_match_jax(fm):
    """Every row: sa_access and csa_access equal JAX's; csa_access equals
    SA[i] wherever it does not bail out to 0 or stop on '$'."""
    port, jax = fm["port"], fm["jax"]
    n = port.length
    rows = np.arange(n)
    np.testing.assert_array_equal(port.sa_access(rows), jax.sa_access(rows))
    got = [port.csa_access(int(i)) for i in rows]
    assert got == [jax.csa_access(int(i)) for i in rows]
    dollar = int(np.flatnonzero(port.bwt == ord("$"))[0])
    exact = sum(g == int(port.sa[i]) for i, g in enumerate(got))
    assert exact > 0.95 * n
    assert all(g == int(port.sa[i]) for i, g in enumerate(got)
               if g != 0 and i != dollar)


@pytest.mark.parametrize("hlen", [3, 5, 6])
def test_lc_build_host_matches_jax_and_both_builds(fm, hlen):
    port = fm["port"]
    got = lc_build_host(port, hlen)
    assert got.dtype == np.uint64 and got.shape == (1 << (2 * hlen), 2)
    want = j_lc_build_host(fm["jax"], hlen)
    assert got.tobytes() == want.tobytes()
    from_sa = lc_build_from_sa(port.sa, encode_bytes(fm["cat"]), hlen)
    assert got.tobytes() == from_sa.tobytes()
    arrays, dollar_pos = bwt_arrays(port)
    idx = DeviceIndex.from_arrays(dict(arrays, c4=port.c4().astype(
        np.int32)), "cpu")
    dev = lc_build_device(idx.packed, idx.occ_samp, idx.c4, dollar_pos,
                          port.length, hlen, chunk=1000)
    assert got.tobytes() == dev.tobytes()
    # absent k-mers (0, 0) are in the comparison: 4^6 k-mers against
    # 12,001 positions leave a few hundred out
    assert (got == 0).all(1).any() == (hlen == 6)


def test_lc_aln_equals_fmi_aln(fm):
    """lchash lookup of the last hlen bases, then the backward search of
    the rest, equals fmi_aln of the whole query (test-lchash.cc:30-48)."""
    port, cat = fm["port"], fm["cat"]
    hlen = 5
    kl = lc_build_host(port, hlen)
    rng = np.random.default_rng(4)
    for _ in range(60):
        qlen = int(rng.integers(hlen, 25))
        start = int(rng.integers(0, len(cat) - 2 - qlen))
        q = encode_bytes(cat[start:start + qlen])
        if (q >= 4).any():
            continue
        num = 0
        for c in q[qlen - hlen:]:
            num = (num << 2) | int(c)
        k, l = int(kl[num, 0]), int(kl[num, 1])
        r1, k1, l1 = ((0, k, l) if (k, l) == (0, 0)
                      else port.fmi_aln(q[:qlen - hlen], k, l))
        r2, k2, l2 = port.fmi_aln(q)
        assert r1 == r2
        if r1:
            assert (k1, l1) == (k2, l2)


def test_lchash_covers_all_kmers(fm):
    port = fm["port"]
    hlen = 4
    kl = lc_build_host(port, hlen)
    for num in range(4 ** hlen):
        codes = np.array([(num >> (2 * (hlen - 1 - i))) & 3
                          for i in range(hlen)], np.uint8)
        r, k, l = port.fmi_aln(codes)
        assert tuple(kl[num]) == ((0, 0) if r == 0 else (k, l))


def test_sa_load_matches_jax(fm):
    got = sa_load(fm["prefix"])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, j_sa_load(fm["prefix"]))
    np.testing.assert_array_equal(got, fm["port"].sa)
