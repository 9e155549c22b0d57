"""The port's affine aligner against the JAX package: `banded_sw_affine` on
the CPU against JAX `banded_sw_affine` (score, end_i, end_j, exact) at band
128 and at bands past 512 (where JAX's TPU lowering takes a doubling scan;
its CPU backend takes cummax at every band, the port's one path), with N
and padding codes, and on reads whose row maxima tie; `affine_align`
(csrc/affine.cpp) against `native.affine_align` in score, span and ops."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from longreadmapper_tpu import native
from longreadmapper_tpu.ops.affine import banded_sw_affine as j_sw
from longreadmapper_tpu_torch.ops.affine import affine_align, \
    banded_sw_affine

torch.set_num_threads(1)


def _mutated(rng, B, L, subs=4, indels=0):
    """q random codes; t = q with `subs` substitutions and `indels` 1-base
    indels a row (t cut or padded with 5 back to L)."""
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = np.empty_like(q)
    for b in range(B):
        s = list(q[b])
        for _ in range(subs):
            p = int(rng.integers(0, L))
            s[p] = (s[p] + int(rng.integers(1, 4))) % 4
        for _ in range(indels):
            p = int(rng.integers(1, L - 1))
            if rng.random() < 0.5:
                del s[p]
            else:
                s.insert(p, int(rng.integers(0, 4)))
        s = (s + [5] * L)[:L]
        t[b] = s
    return q, t


def _both(q, t, W, band):
    want = [np.asarray(x) for x in j_sw(jnp.asarray(q), jnp.asarray(t), W,
                                        band)]
    got = banded_sw_affine(torch.from_numpy(q), torch.from_numpy(t), W, band)
    assert all(g.dtype == torch.int32 and g.shape == (q.shape[0],)
               for g in got)
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("B,L,W,band,indels", [
    (8, 64, 16, 128, 0),          # tests/test_aligners.py's shape
    (8, 64, 16, 128, 2),
    (6, 96, 40, 640, 2),          # past 512: JAX's TPU doubling-scan band
    (4, 200, 300, 1024, 3),       # a band wider than the read
    (5, 50, 3, 7, 1),             # a band narrower than 2W + 1
])
def test_banded_sw_affine_matches_jax(B, L, W, band, indels):
    rng = np.random.default_rng(B * L + band)
    q, t = _mutated(rng, B, L, indels=indels)
    q[0, 5:9] = 4                                 # N in the read
    t[1, 20:30] = 5                               # padding in the target
    t[-1] = 5                                     # nothing scores
    got, want = _both(q, t, W, band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][-1] == got[1][-1] == got[2][-1] == 0
    assert (got[0][:-1] > 0).all()


def test_banded_sw_affine_ties_take_the_first_cell():
    """Rows whose maximum ties across the band: a homopolymer against itself
    (row i scores 2i at every j >= i), a period-2 tandem (every other
    column), and a read ending in N (later rows tie the best score)."""
    L, W, band = 48, 8, 32
    q = np.zeros((3, L), np.int8)
    q[1] = np.arange(L) % 2
    q[2] = np.random.default_rng(1).integers(0, 4, L)
    t = q.copy()
    q[2, 30:] = 4
    got, want = _both(q, t, W, band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sc, ei, ej = got
    assert list(sc) == [2 * L, 2 * L, 60] and list(ei) == [L, L, 30]
    assert list(ej) == list(ei)                   # the diagonal, first


def _pair(case: str):
    rng = np.random.default_rng(["random", "indel", "none", "n_codes",
                                 "long"].index(case))
    if case == "none":
        return np.zeros(10, np.uint8), np.full(10, 3, np.uint8), 8
    if case == "indel":
        q = rng.integers(0, 4, 50).astype(np.uint8)
        return q, np.concatenate([q[:20], q[23:]]).astype(np.uint8), 16
    m = 300 if case == "long" else int(rng.integers(20, 60))
    q = rng.integers(0, 4, m).astype(np.uint8)
    t = q.copy()
    for _ in range(3 if case != "long" else 12):
        p = int(rng.integers(0, m))
        t[p] = (t[p] + 1) % 4
    if case == "long":
        t = np.concatenate([t[:100], rng.integers(0, 4, 5).astype(np.uint8),
                            t[100:200], t[204:]])
    if case == "n_codes":
        q[5:8] = 4
        t[-4:] = 4
    return q, t, 16


@pytest.mark.parametrize("case", ["random", "indel", "none", "n_codes",
                                  "long"])
def test_affine_align_matches_native(case):
    q, t, W = _pair(case)
    got = affine_align(q, t, W)
    want = native.affine_align(q, t, W)
    assert got == want
    score, span, ops = got
    if case == "none":
        assert (score, span, ops) == (0, None, None)
        return
    assert score > 0
    assert sum(c for c, op in ops if op in "MI") == span[1] - span[0]
    assert sum(c for c, op in ops if op in "MD") == span[3] - span[2]
    if case == "indel":
        assert (3, "I") in ops


def test_affine_align_ends_equal_the_batch_scorer():
    """For band 2W + 1 the scorer's best cell is affine_align's end."""
    rng = np.random.default_rng(9)
    B, L, W = 6, 80, 10
    q, t = _mutated(rng, B, L, subs=5, indels=1)
    sc, ei, ej = [x.numpy() for x in banded_sw_affine(
        torch.from_numpy(q), torch.from_numpy(t), W, 2 * W + 1)]
    for b in range(B):
        score, span, _ = affine_align(q[b], t[b], W)
        assert (sc[b], ei[b], ej[b]) == (score, span[1], span[3]), b
