"""Inputs of the step glue's tests (ops/step.py: encode_raw, locate_window,
lanes, pack, gact_setup), made with numpy from a seed, and scalar models
of csrc/lanes.cuh::lane_of and csrc/step.cu::lanes_kernel, shared by the
CPU tests (tests/test_torch_glue.py, tests/test_torch_walk.py) and the
card-only ones (tests/test_torch_glue_card.py).  Imports neither JAX nor
conftest, so the card-only tests can import it where JAX is absent.

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


# a ragged part's read lengths: 0, 1, 15-17 (one 16-base window and either
# side of it), 2063-2065 (15-17 past a CTA's 2048-base chunk), and the
# bucket's L
RAGGED_LENS = (0, 1, 15, 16, 17, 2063, 2064, 2065)


def ragged_case(rng, L: int):
    """(name, seq, qual) reads of RAGGED_LENS and L bases, upper and lower
    case bases, N and n among them, in a shuffled order."""
    alphabet = np.array(list("ACGTacgtNn"))
    lens = list(RAGGED_LENS) + [L]
    rng.shuffle(lens)
    return [(f"r{i}", "".join(alphabet[rng.integers(0, alphabet.size, n)]),
             None) for i, n in enumerate(lens)]


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


def lanes_edges(L: int = 40, Wp: int = 64):
    """lanes_case's arrays on crafted lanes, (len, ed at len, limit,
    found, overflow) each: len 0 and len L, found false, ed == Wp with
    limit == Wp (band-short when narrow), ed == Wp over a limit Wp - 1,
    ed Wp - 1 under limit Wp, ed == limit and limit + 1, overflow set on
    a live lane and on a dead one, ed 0 at limit 0."""
    specs = [(0, 5, 10, True, False), (L, 7, 9, True, False),
             (L, 3, 50, False, False), (L // 2, Wp, Wp, True, False),
             (L // 3, Wp, Wp - 1, True, True), (L - 1, Wp - 1, Wp, True,
                                                 False),
             (5, 20, 20, True, True), (6, 21, 20, True, False),
             (L, Wp + 9, 200, True, True), (0, 0, 0, True, False),
             (1, Wp, Wp + 5, False, True)]
    rng = np.random.default_rng(L + Wp)
    B = len(specs)
    wcol = rng.integers(-3, 200, (L + 1, B)).astype(np.int16)
    lens, limit, found, overflow = (np.array(x) for x in zip(*[
        (n, lim, f, o) for n, _, lim, f, o in specs]))
    for b, (n, ed, *_) in enumerate(specs):
        wcol[n, b] = ed
    return (wcol, lens.astype(np.int32), limit.astype(np.int32),
            found.astype(bool), overflow.astype(bool))


def model_lane(wcol, lens, limit, found, ovf, Wp: int, narrow: bool, b):
    """csrc/lanes.cuh::lane_of for lane b, as the CUDA is written, in
    Python integers: (ed_raw, band_short, overflow, walk_len)."""
    L, B = wcol.shape[0] - 1, wcol.shape[1]
    n = int(lens[b])
    row = 0 if n < 0 else (L if n > L else n)
    ed = int(np.asarray(wcol).reshape(-1)[row * B + b])
    lim = int(limit[b])
    f = bool(found[b])
    short = bool(narrow) and f and ed >= Wp and lim >= Wp
    return (ed, int(short), (1 if ovf[b] else 0) | (4 if short else 0),
            n if f and ed <= lim and not short else 0)


def model_gact_setup(walk_len, B: int, n_rows: int, threads: int = 256,
                     max_blocks: int = 4096, eb: int = 2):
    """csrc/step.cu::lanes_kernel<eb> as it is written, a grid of
    `threads` thread blocks sized as lrm_gact_setup sizes it (the fill's
    blocks at most `max_blocks`, a thread for each lane and shared word),
    over buffers of garbage: thread t < B writes lane t's (i, j, done)
    from walk_len(t), threads B .. B + 2 zero the shared words, and the
    grid fills the run buffer, four int32 words at a time (a word a pad
    pair of int16 entries, two a pair of int32), then the words past the
    last four.  Returns (st (3B + 3) int32, buf (B, 2 n_rows) int16, or
    int32 where eb is 4)."""
    st = np.full(3 * B + 3, -0x5A5A5A5B, np.int64)
    words = np.full(B * n_rows * (eb // 2), 0x5A5A5A5A, np.int64)
    blocks = min(-(-(len(words) // 4) // threads), max_blocks)
    nt = max(blocks, -(-(B + 3) // threads)) * threads
    pad = (3 << 16) | 3 if eb == 2 else 3
    vecs = len(words) >> 2
    for t in range(nt):
        if t < B:
            n = walk_len(t)
            st[t] = st[B + t] = n
            st[2 * B + t] = n <= 0
        elif t < B + 3:
            st[2 * B + t] = 0
        for k in range(t, vecs, nt):
            words[4 * k:4 * k + 4] = pad
        for k in range(4 * vecs + t, len(words), nt):
            words[k] = pad
    buf = words.astype(np.uint32).view(np.int16 if eb == 2 else np.int32
                                       ).reshape(B, 2 * n_rows)
    return st.astype(np.int32), buf


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
