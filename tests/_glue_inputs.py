"""Inputs of the step glue's tests (ops/step.py: encode_raw, locate_window,
lanes, pack), made with numpy from a seed, shared by the CPU tests
(tests/test_torch_glue.py) and the card-only ones
(tests/test_torch_glue_card.py).  Imports neither JAX nor conftest, so
the card-only tests can import it where JAX is absent.

The contig tables are laid out as the .cat is (formats/catmeta.py): each
contig's forward half then its reverse half, one after another, and the
'$' last; zero-length contigs share their start with the next contig."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from longreadmapper_tpu_torch.ops.rank import pack_codes

I31 = (1 << 31) - 1
# name -> (first start, contig lengths, position dtype)
TABLES = {
    "int32": (0, [50, 0, 0, 37, 1, 200, 0, 64], np.int32),
    # positions near 2^31 - 1: loc + qlen and start + 2 * len wrap
    "wrap": (I31 - 700, [100, 0, 150, 300], np.int32),
    # starts above 2^32
    "int64": ((1 << 32) + 5, [120, 0, 33, 500], np.int64),
}


def cfg(B: int, L: int, n: int, pos64: bool = False, use_gact: bool = False,
        entry_bytes: int = 2):
    """The MapperConfig fields that ops/step.py reads."""
    return SimpleNamespace(B=B, L=L, n=n, pos64=pos64, use_gact=use_gact,
                           tb_entry_bytes=entry_bytes,
                           meta_words=10 if pos64 else 8, OPS_HEAD_COLS=16)


def contig_table(name: str):
    """(start, slen, n) of TABLES[name]: n is one past the '$'; the wrapped
    table's n is 2^31 - 1, its positions past it wrap."""
    first, lens, dtype = TABLES[name]
    lens = np.array(lens, np.int64)
    start = first + np.concatenate([[0], np.cumsum(2 * lens)[:-1]])
    n = I31 if name == "wrap" else int(start[-1] + 2 * lens[-1] + 1)
    return start.astype(dtype), lens.astype(dtype), n


def locate_case(name: str, rng):
    """(loc, qlen) of the table TABLES[name]: every contig's edges (its
    start, its forward half's end, its reverse half's end, one either
    side) at lengths 0, 1, 5 and the half's length, boundaries between
    contigs and halves among them; reads outside every contig; random
    reads.  loc is int32 (int64 for the int64 table), its int32 loc + qlen
    wrapping for the wrapped table."""
    start, slen, n = contig_table(name)
    locs, qlens = [], []
    for s, ln in zip(start.astype(np.int64), slen.astype(np.int64)):
        for q in sorted({0, 1, 5, int(ln), int(ln) + 1}):
            for p in (s, s + ln, s + 2 * ln):
                for d in (-q - 1, -q, -q + 1, -1, 0, 1):
                    locs.append(p + d)
                    qlens.append(q)
    lo, hi = int(start[0]), int(start[-1]) + 2 * int(slen[-1])
    for p in (lo - 5, -7, 0, hi + 3, hi + 1000):
        locs.append(p)
        qlens.append(3)
    k = 64
    locs += list(rng.integers(lo - 20, hi + 20, k))
    qlens += list(rng.integers(0, 260, k))
    if name == "wrap":
        locs += [I31, I31 - 1, I31 - 120]
        qlens += [1, 300, 300]
    loc = np.array(locs, np.int64)
    if name != "int64":
        loc = loc.astype(np.uint64).astype(np.uint32).view(np.int32)
    return loc, np.array(qlens, np.int32)


def text(rng, n: int):
    """(codes (n,) int8: random bases and the '$' as 4 at n - 1, the
    packed text (ceil(n / 16),) int32 as the index packs it)."""
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n - 1] = 4
    return codes, pack_codes(np.where(codes < 4, codes, 0))


def window_case(rng, L: int, n: int = 3001):
    """A random text of n codes under a table of one contig whose forward
    half is the whole text before the '$' (so a read's window starts where
    it does), and reads that start at every sub-word offset, near the
    text's end, at the '$', and unfound (loc -1): (idx, loc, qlen, codes
    of the text)."""
    codes, packed = text(rng, n)
    locs = [16 * k + o for k in (0, 1, 37) for o in range(16)]
    locs += [n - 1 - L - 3, n - 1 - L, n - L + 4, n - 17, n - 2, n - 1, -1]
    loc = np.array(locs, np.int32)
    qlen = np.where(loc == n - 1, 0, 1).astype(np.int32)
    idx = SimpleNamespace(
        mta_start=torch.tensor([0], dtype=torch.int32),
        mta_len=torch.tensor([n - 1], dtype=torch.int32),
        text_packed=torch.from_numpy(packed))
    return idx, loc, qlen, codes


def raw_case(rng, B: int, L: int, L0: int):
    """(B, L) uint8 reads L0 long of mixed-case bases, N, other letters
    and bytes, garbage (not 0) past L0; the last row all garbage."""
    alphabet = np.frombuffer(b"ACGTacgtNnRxX-\x00\xff\x41\x61", np.uint8)
    raw = rng.integers(0, 256, (B, L)).astype(np.uint8)
    raw[:, :L0] = alphabet[rng.integers(0, alphabet.shape[0], (B, L0))]
    raw[-1] = rng.integers(0, 256, L)
    return raw


def lanes_case(rng, B: int, L: int):
    """(wcol (L+1, B) int16, lens, limit, found, overflow) with eds on both
    sides of the limits and of Wp 64, lens 0 and L among them."""
    wcol = rng.integers(-3, 200, (L + 1, B)).astype(np.int16)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = 0
    lens[1:2] = L
    limit = rng.integers(0, 130, B).astype(np.int32)
    found = rng.random(B) < 0.8
    overflow = rng.random(B) < 0.2
    return wcol, lens, limit, found, overflow


def pack_case(rng, B: int, R: int, eb: int, pos64: bool):
    """The pack's inputs: per-read values (positions above 2^32 and
    negative under pos64) and (B, R) run entries of every op, pads (op 3)
    of different counts among them; row 0 all pads, row 1 none."""
    pdt = np.int64 if pos64 else np.int32
    span = (1 << 40) if pos64 else (1 << 31)
    best = rng.integers(-span, span, B).astype(pdt)
    off = rng.integers(-span, span, B).astype(pdt)
    vals = dict(
        best=best, off=off, found=rng.random(B) < 0.7,
        gi=rng.integers(0, 90, B).astype(np.int32),
        strand=rng.random(B) < 0.5,
        ed_raw=rng.integers(-1, 300, B).astype(np.int32),
        limit=rng.integers(0, 250, B).astype(np.int32),
        band_short=rng.random(B) < 0.2,
        overflow=rng.integers(0, 8, B).astype(np.int32))
    bits = 8 * eb
    count = rng.integers(0, 1 << (bits - 2), (B, R))
    op = rng.integers(0, 4, (B, R))
    op[0] = 3
    op[1:2] = rng.integers(0, 3, R)
    e = (count << 2) | op
    e = np.where(e >= 1 << (bits - 1), e - (1 << bits), e)   # two's compl.
    vals["runs"] = e.astype(np.int16 if eb == 2 else np.int32)
    return vals


def to_torch(vals: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in vals.items()}
