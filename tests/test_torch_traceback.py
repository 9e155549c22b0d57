"""Column-consuming CIGAR walk of the port (ops/traceback.py) against the
JAX ops/traceback.device_traceback_c: the same direction words and group
bitmap go in, the run entries must be equal (patterns of
tests/test_tb_cols.py: ragged lengths, heavy indel mixes, a dead lane,
over-limit lanes masked, pure-match reads), and the int32 entries of the
resident long-read buckets (counts of 8192 and more)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from longreadmapper_tpu.ops.traceback import (device_traceback_c,
                                              traceback_c_iters)
from longreadmapper_tpu.ops.wavefront import banded_nw_dirs_v
from longreadmapper_tpu_torch.ops import traceback as ttb

torch.set_num_threads(1)


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


def _walk_both(q, t, lens, L, W, band, wide_entries=False):
    vdirs, wcol, nm = banded_nw_dirs_v(jnp.asarray(q), jnp.asarray(t), W,
                                       band, with_nm=True)
    ed = np.asarray(wcol)[lens, np.arange(q.shape[0])]
    lens_tb = np.where(ed <= W, lens, 0).astype(np.int32)
    want = np.asarray(device_traceback_c(
        vdirs, jnp.asarray(lens_tb), L, W, nm=nm,
        entry_dtype=jnp.int32 if wide_entries else jnp.int16))
    got = ttb.device_traceback_c(
        torch.from_numpy(np.array(vdirs)), torch.from_numpy(lens_tb), L, W,
        torch.from_numpy(np.array(nm).view(np.int32)),
        entry_dtype=torch.int32 if wide_entries else torch.int16).numpy()
    return want, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cwalk_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, L, W, band = 16, 256, 24, 128
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        qb = rng.integers(0, 4, n)
        tb = _mutate(rng, list(qb), int(rng.integers(0, 6)),
                     int(rng.integers(0, W // 2)))
        tb = (tb + [5] * L)[:L]
        q[b, :n] = qb
        t[b, :len(tb)] = tb
        lens[b] = n
    lens[0] = 0                                   # dead lane
    want, got = _walk_both(q, t, lens, L, W, band)
    assert got.dtype == np.int16
    assert got.shape == (B, 2 * traceback_c_iters(L, W))
    np.testing.assert_array_equal(got, want)


def test_cwalk_two_bitmap_words():
    """L = 1024 gives 64 groups, two nm words per (b, d): indels far apart
    make the walk search below a 32-group boundary."""
    rng = np.random.default_rng(5)
    B, L, W, band = 6, 1024, 40, 128
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = np.full((B, L), 5, np.int8)
    for b in range(B):
        tb = _mutate(rng, list(q[b]), 20, 3)[:L]
        t[b, :len(tb)] = tb
    want, got = _walk_both(q, t, np.full(B, L, np.int32), L, W, band)
    np.testing.assert_array_equal(got, want)


def test_cwalk_pure_match():
    rng = np.random.default_rng(9)
    B, L, W, band = 4, 128, 16, 128
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    want, got = _walk_both(q, q.copy(), np.full(B, L, np.int32), L, W, band)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == (L << 2)).all()          # one L-long M entry


def test_cwalk_int32_entries_at_8192():
    """L = 8192 (the resident 10 kb path ships int32 entries): a pure-match
    read's single M-run of 8192 overflows int16's 14-bit count field, and
    indel reads walk across 16 bitmap words."""
    rng = np.random.default_rng(8192)
    B, L, W, band = 3, 8192, 40, 128
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = q.copy()
    for b in (1, 2):
        tb = _mutate(rng, list(q[b]), 12, 4 * b)[:L]
        t[b] = 5
        t[b, :len(tb)] = tb
    want, got = _walk_both(q, t, np.full(B, L, np.int32), L, W, band,
                           wide_entries=True)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == L << 2
    assert ((got[1:] & 3 == 1) | (got[1:] & 3 == 2)).sum(axis=1).min() > 0


def test_msb32_is_exact():
    x = torch.tensor([0, 1, 2, 3, 4, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                      0x10000, 0xFFFF], dtype=torch.int64)
    want = [-1, 0, 1, 1, 2, 30, 31, 31, 16, 15]
    assert ttb.msb32(x).tolist() == want
