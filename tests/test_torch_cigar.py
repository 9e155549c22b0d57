"""The SAM assembly's CIGAR strings (models/mapper.py::_Cigars over
csrc/cigar.cpp) against a pure-Python oracle: the run decode the port's
mapper used before the native helper (numpy `_rle_groups`, kept here),
with one f-string a merged group.  Entries of 1, 2 and 4 bytes; empty and
all-pad rows, count-0 and negative entries between runs of one op, the
widest count of each width, rows that reach their last slot, a width that
is not a whole number of entries, a row stride wider than the row, B 1."""

import numpy as np
import pytest

from longreadmapper_tpu_torch.models.mapper import _Cigars

WIDTHS = {1: np.int8, 2: np.int16, 4: np.int32}


def _rle_groups(runs: np.ndarray, entry_bytes: int = 1):
    """Merged forward-order groups (g_row, g_op, tot) of a chunk's run
    entries ((count << 2) | op in reverse path order, little-endian)."""
    if entry_bytes > 1:
        w = runs.shape[1] - runs.shape[1] % entry_bytes
        runs = np.ascontiguousarray(runs[:, :w]).view(
            np.int16 if entry_bytes == 2 else np.int32)
    rev = runs[:, ::-1]
    op = rev & 3
    cnt = (rev >> 2).astype(np.int64)
    valid = (op != 3) & (cnt > 0)
    rows, cols = np.nonzero(valid)
    if rows.size == 0:
        return rows, rows, rows
    ops_f = op[rows, cols]
    cnt_f = cnt[rows, cols]
    brk = np.empty(rows.size, dtype=bool)
    brk[0] = True
    brk[1:] = (rows[1:] != rows[:-1]) | (ops_f[1:] != ops_f[:-1])
    starts = np.flatnonzero(brk)
    return rows[starts], ops_f[starts], np.add.reduceat(cnt_f, starts)


def _oracle(runs: np.ndarray, entry_bytes: int) -> list:
    parts = [[] for _ in range(runs.shape[0])]
    for r, o, t in zip(*(a.tolist() for a in _rle_groups(runs, entry_bytes))):
        parts[r].append(f"{t}{'MID'[o]}")
    return ["".join(p) for p in parts]


def _entry(count, op, eb):
    return np.array([(count << 2) | op], WIDTHS[eb])


def _rows(rng, eb, B, n):
    """(B, n * eb) int8 run bytes: random rows of runs, pads, count-0 and
    negative entries, plus each special row the decode must get right."""
    dt = WIDTHS[eb]
    top = (int(np.iinfo(dt).max) >> 2)
    e = np.empty((B, n), dt)
    for r in range(B):
        ops = rng.choice(4, n, p=[0.5, 0.2, 0.2, 0.1])
        cnt = np.where(rng.random(n) < 0.05, top,
                       rng.integers(0, min(top, 40) + 1, n))
        row = (cnt.astype(np.int64) << 2) | ops
        neg = rng.random(n) < 0.05
        row[neg] = rng.integers(int(np.iinfo(dt).min), 0, int(neg.sum()))
        pad_from = int(rng.integers(0, n + 1))    # a row's unused tail
        row[pad_from:] = (int(rng.integers(0, top + 1)) << 2) | 3
        e[r] = row.astype(dt)
    special = [
        np.zeros(n, dt),                                 # empty
        np.full(n * eb, 3, np.int8).view(dt),            # all pad bytes
        # count-0 and negative entries between two runs of one op: merge
        np.concatenate([_entry(5, 1, eb), _entry(0, 1, eb), _entry(0, 2, eb),
                        np.array([-1 << (8 * eb - 1)], dt), _entry(7, 1, eb),
                        np.full(n - 5, 3, dt)]),
        np.full(n, (top << 2) | 2, dt),                  # widest counts
        np.concatenate([np.full(n - 1, 3, dt), _entry(top, 0, eb)]),
    ]
    e[:len(special)] = np.stack(special)
    return np.ascontiguousarray(e).view(np.int8)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("eb", [1, 2, 4])
def test_cigars_match_the_python_oracle(eb, seed):
    rng = np.random.default_rng(seed)
    cig = _Cigars()
    n = int(rng.integers(6, 300))
    runs = _rows(rng, eb, int(rng.integers(6, 40)), n)
    assert cig(runs, eb) == _oracle(runs, eb)
    # a row's width past its last whole entry is dropped
    odd = np.concatenate(
        [runs, rng.integers(-128, 128, (runs.shape[0], eb - 1 or 1),
                            dtype=np.int8)], axis=1)[:, :n * eb + eb - 1]
    assert cig(odd, eb) == _oracle(odd, eb)
    # rows as views of a wider buffer (the blob's run bytes), and B 1
    wide = np.concatenate([np.full((runs.shape[0], 7), 9, np.int8), runs],
                          axis=1)[:, 7:]
    assert wide.strides[0] > wide.shape[1]
    assert cig(wide, eb) == _oracle(runs, eb)
    assert cig(runs[-1:], eb) == _oracle(runs[-1:], eb)
    # the kept buffer serves a smaller call, then a larger one
    assert cig(runs[:2, :eb], eb) == _oracle(runs[:2, :eb], eb)
    big = _rows(rng, eb, 64, 2 * n)
    assert cig(big, eb) == _oracle(big, eb)


@pytest.mark.parametrize("eb", [1, 2, 4])
def test_cigar_of_known_rows(eb):
    """Rows written out by hand: reverse path order, merges across a
    count-0 and a pad entry, the widest count twice in one group."""
    top = (int(np.iinfo(WIDTHS[eb]).max) >> 2)
    rows = [
        [(3, 0), (2, 2), (0, 2), (1, 3), (4, 2), (5, 1), (6, 0)],
        [(top, 1), (top, 1), (1, 3)],
        [(0, 0), (9, 3)],
    ]
    runs = np.stack([np.concatenate([_entry(c, o, eb) for c, o in r]
                                    + [np.full(7 - len(r), 3, WIDTHS[eb])])
                     for r in rows]).view(np.int8)
    assert _Cigars()(runs, eb) == ["6M5I6D3M", f"{2 * top}I", ""]


def test_cigars_refuse_what_is_not_run_bytes():
    cig = _Cigars()
    assert cig(np.zeros((0, 8), np.int8), 4) == []
    with pytest.raises(ValueError):
        cig(np.zeros((2, 8), np.int16), 2)
    with pytest.raises(ValueError):
        cig(np.zeros((2, 8), np.int8), 3)
