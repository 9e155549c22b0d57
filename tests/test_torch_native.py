"""The port's edlib-equivalent host aligners (longreadmapper_tpu_torch/
native.py over csrc/align.cpp and csrc/myers.cpp) against the JAX
package's (longreadmapper_tpu/native) on the same inputs, exactly: the
cases of tests/test_aligners.py (Myers distance in each mode with and
without the k bound, the HW / SHW / NW paths, the extended CIGAR, the
planted long read, empty sequences), banded_align, and the traceback over
the score matrix of the port's ops/wavefront.banded_nw_scores.  Brute DPs
hold both to the edit distance."""

import numpy as np
import pytest
import torch

from longreadmapper_tpu import native as jnative
from longreadmapper_tpu_torch import native, native_build
from longreadmapper_tpu_torch.ops.wavefront import banded_nw_scores
from test_aligners import _apply_ops, _brute_infix, brute_edit

torch.set_num_threads(1)
MODES = ["NW", "SHW", "HW"]


def _pair(seed, m_lo=3, m_hi=200, n_hi=260):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(m_lo, m_hi))
    n = int(rng.integers(m_lo, n_hi))
    return (rng.integers(0, 4, m).astype(np.uint8),
            rng.integers(0, 4, n).astype(np.uint8))


def _similar(seed, m, n_edits, flank=30):
    """(q, t): t is q with substitutions and 1-base indels, inside a
    random flank of up to `flank` bases on each side."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.uint8)
    s = list(q)
    for _ in range(n_edits):
        p, kind = int(rng.integers(0, len(s))), int(rng.integers(0, 3))
        if kind == 0:
            s[p] = (s[p] + 1) % 4
        elif kind == 1:
            del s[p]
        else:
            s.insert(p, int(rng.integers(0, 4)))
    side = lambda: list(rng.integers(0, 4, int(rng.integers(0, flank + 1))))
    return q, np.array(side() + s + side(), np.uint8)


def _check_path(q, t, res):
    ed, start, end, ops = res
    edits, qc, tc = _apply_ops(q, t[start:end], ops)
    assert (edits, qc, tc) == (ed, len(q), end - start)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 5, 9])
def test_myers_distance_matches_jax_and_brute(mode, seed):
    q, t = _pair(seed)
    q[::17] = 4                              # N matches nothing
    got = native.myers_distance(q, t, mode)
    assert got == jnative.myers_distance(q, t, mode)
    assert got[0] == brute_edit(q, t, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(4))
def test_myers_k_bounded_matches_jax(mode, seed):
    q, t = _pair(seed)
    d, pos = native.myers_distance(q, t, mode)
    for k in (0, 1, d - 1, d, d + 1, d + 17):
        if k < 0:
            continue
        got = native.myers_distance(q, t, mode, k=k)
        assert got == jnative.myers_distance(q, t, mode, k=k), (mode, k)
        assert got == ((d, pos) if d <= k else (-1, 0)), (mode, k)


def test_myers_infix_location_and_banded_nw():
    rng = np.random.default_rng(11)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = t[100:180].copy()
    q[10] = (q[10] + 1) % 4
    assert native.myers_distance(q, t, "HW") == (1, 180)
    rng = np.random.default_rng(13)
    q = rng.integers(0, 4, 120).astype(np.uint8)
    t = q.copy()
    t[40] = (t[40] + 1) % 4
    t = np.concatenate([t[:70], t[72:]]).astype(np.uint8)
    assert native.myers_distance(q, t, "NW")[0] == 3
    got = native.banded_align(q, t, 16)
    assert got == jnative.banded_align(q, t, 16)
    assert got[0] == 3


def test_myers_k_bounded_planted_long():
    rng = np.random.default_rng(21)
    t = rng.integers(0, 4, 4000).astype(np.uint8)
    q = t[1000:1800].copy()                  # 13 blocks of 64
    q[100] = (q[100] + 1) % 4
    q[500] = (q[500] + 1) % 4
    for args in ((q, t, "HW", 5), (q, t, "HW", 1),
                 (q, t[1000:1800], "NW", 4)):
        assert native.myers_distance(*args) == jnative.myers_distance(*args)
    assert native.myers_distance(q, t, "HW", k=5) == (2, 1800)
    assert native.myers_distance(q, t, "HW", k=1) == (-1, 0)
    res = native.myers_align(q, t, "HW", k=5)
    assert res == jnative.myers_align(q, t, "HW", k=5)
    assert res[:3] == (2, 1000, 1800)
    _check_path(q, t, res)


@pytest.mark.parametrize("seed", range(8))
def test_myers_align_hw_path_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(8, 40))
    n = int(rng.integers(m, 160))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = rng.integers(0, 4, n).astype(np.uint8)
    res = native.myers_align(q, t, "HW")
    assert res == jnative.myers_align(q, t, "HW")
    assert res[0] == _brute_infix(q, t)[0]
    _check_path(q, t, res)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(3))
def test_myers_align_modes_match_jax(mode, seed):
    """Each mode's window and path on a similar pair (flanks, indels and
    an N in the query), equal to JAX's and spelling the distance."""
    q, t = _similar(seed, 150, 6)
    q[7] = 4
    res = native.myers_align(q, t, mode)
    assert res == jnative.myers_align(q, t, mode)
    assert res[0] == brute_edit(q, t, mode)
    if mode == "NW":
        assert res[1:3] == (0, len(t))
    elif mode == "SHW":
        assert res[1] == 0
    _check_path(q, t, res)


def test_myers_align_hw_planted():
    rng = np.random.default_rng(99)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = t[100:160].copy()
    q[10] = (q[10] + 1) % 4
    q = np.concatenate([q[:30], q[31:]]).astype(np.uint8)
    res = native.myers_align(q, t, "HW")
    assert res == jnative.myers_align(q, t, "HW")
    assert res[:3] == (2, 100, 160)
    _check_path(q, t, res)


@pytest.mark.parametrize("seed", range(4))
def test_myers_align_extended_cigar_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(20, 80))
    n = int(rng.integers(m, 200))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = rng.integers(0, 4, n).astype(np.uint8)
    q[3] = 4
    ed, start, end, xops = native.myers_align(q, t, "HW", extended=True)
    assert (ed, start, end, xops) == jnative.myers_align(q, t, "HW",
                                                         extended=True)
    assert all(op in "=XID" for _, op in xops)
    plain = native.myers_align(q, t, "HW")[3]
    assert native.ops_extended(q, t, start, plain) == xops
    assert jnative.ops_extended(q, t, start, plain) == xops
    n_x = sum(ln for ln, op in xops if op in "XID")
    assert n_x == ed


def test_myers_align_k_bounded_matches_jax():
    rng = np.random.default_rng(31)
    t = rng.integers(0, 4, 500).astype(np.uint8)
    q = t[50:150].copy()
    q[10] = (q[10] + 1) % 4
    for k in (0, 1, 2):
        assert native.myers_align(q, t, "HW", k=k) == \
            jnative.myers_align(q, t, "HW", k=k)
    assert native.myers_align(q, t, "HW", k=0) == (-1, 0, 0, [])
    assert native.myers_align(q, t, "HW", k=1)[:3] == (1, 50, 150)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [-1, 0, 2, 5])
def test_empty_query_and_target_match_jax(mode, k):
    q = np.array([0, 1, 2], np.uint8)
    empty = np.zeros(0, np.uint8)
    for a, b in ((q, empty), (empty, q), (empty, empty)):
        assert native.myers_distance(a, b, mode, k) == \
            jnative.myers_distance(a, b, mode, k)
        assert native.myers_align(a, b, mode, k) == \
            jnative.myers_align(a, b, mode, k)
    assert native.myers_distance(q, empty, mode) == (3, 0)


@pytest.mark.parametrize("seed,W", [(0, 4), (1, 8), (2, 16), (3, 2)])
def test_banded_align_matches_jax(seed, W):
    """In band (the best in-band path, no cheaper than the global one),
    and out of band (-1, None) where |len(t) - len(q)| passes W."""
    q, t = _similar(seed, 120, 5, flank=0)
    t = np.concatenate([t, q[:3]]).astype(np.uint8)
    got = native.banded_align(q, t, W)
    assert got == jnative.banded_align(q, t, W)
    if abs(len(t) - len(q)) > W:
        assert got == (-1, None)
    else:
        assert got[0] >= brute_edit(q, t, "NW")
        assert _apply_ops(q, t, got[1]) == (got[0], len(q), len(t))
    wide = native.banded_align(q, t, 64)
    assert wide == jnative.banded_align(q, t, 64)
    assert wide[0] == brute_edit(q, t, "NW")


@pytest.mark.parametrize("seed", range(3))
def test_traceback_over_port_scores_matches_jax(seed):
    """native.traceback over each read's (L+1, band) slice of the port's
    banded_nw_scores: JAX's ops, the banded aligner's distance, and None
    where the end cell lies outside the band."""
    rng = np.random.default_rng(seed)
    B, L, W = 3, 60, 10
    band = 2 * W + 1
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    t = q.copy()
    t[0] = np.concatenate([q[0, :20], q[0, 22:], rng.integers(0, 4, 2)])
    t[1, ::9] = (t[1, ::9] + 1) % 4
    t[2] = np.roll(q[2], 3)
    H = banded_nw_scores(torch.from_numpy(q.astype(np.int8)),
                         torch.from_numpy(t.astype(np.int8)), W,
                         band).numpy()
    for b in range(B):
        Hb = H[:, b, :]
        ops = native.traceback(Hb, W, q[b], t[b], L, L)
        assert ops == jnative.traceback(Hb, W, q[b], t[b], L, L)
        ed, ops_b = native.banded_align(q[b], t[b], W)
        assert ed == int(Hb[L, W]) and ops == ops_b
        assert _apply_ops(q[b], t[b], ops) == (ed, L, L)
        for qlen, tlen in ((L - W - 1, L), (30, 30)):
            got = native.traceback(Hb, W, q[b], t[b], qlen, tlen)
            assert got == jnative.traceback(Hb, W, q[b], t[b], qlen, tlen)
        assert native.traceback(Hb, W, q[b], t[b], L - W - 1, L) is None


def test_failed_build_raises(tmp_path, monkeypatch):
    """No numpy fallback: a source that does not compile raises with
    g++'s message at the first call."""
    (tmp_path / "myers.cpp").write_text("int broken(\n")
    monkeypatch.setattr(native_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native_build, "_libs", {})
    q = np.zeros(4, np.uint8)
    with pytest.raises(RuntimeError, match="myers.cpp: g\\+\\+ exit"):
        native.myers_distance(q, q)
