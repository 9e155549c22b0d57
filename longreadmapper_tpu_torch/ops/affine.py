"""Affine-gap Smith-Waterman, the SSW-equivalent aligner: the port of
longreadmapper_tpu/ops/affine.py (`banded_sw_affine`) and of
longreadmapper_tpu/native/__init__.py::affine_align.

The reference vendors Mengyao Zhao's striped Smith-Waterman as a standalone
library, not linked into accaln; its wrapper `compute_cigar` scores a 5x5
DNA matrix with match +2, mismatch -2, gap open 3, gap extend 1, and N
scoring 0 against everything (the reference's ssw/ssw_use.c:27-54).

`banded_sw_affine` scores a batch on the tensors' device, vectorized over
the reads in the banded layout of ops/wavefront.py (band coordinate d = j -
i + W), one Python loop over the L rows.  Per row i (oe = open + ext, the
cost of a gap's first base in ssw's convention):

    F(i,j) = max(H(i-1,j) - oe, F(i-1,j) - ext)          (gap in query)
    A(i,j) = max(0, H(i-1,j-1) + s(q_i,t_j), F(i,j))     (non-E part)
    E(i,j) = max_{c<j} A(i,c) - oe - ext*(j-1-c)         (gap in target)
    H(i,j) = max(A, E)

E is exact unrolled this way because a gap never profitably re-enters
through a previous E (oe >= ext); its max-plus prefix is one cummax of A +
ext*d, exact at every band.  JAX computes this op in XLA, not in a Pallas
kernel, and it is off the map path: it stays plain PyTorch.

`affine_align` is the traceback for one pair, the port's copy of
native/affine.cpp (csrc/affine.cpp, built with g++ at first use).  A failed
build raises with g++'s message; there is no numpy fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native_build

NEG = -(1 << 20)

_P, _I = ctypes.c_void_p, ctypes.c_int32
_FUNCS = {"lrm_affine_align": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                               _I, _P]}


def banded_sw_affine(q: torch.Tensor, t: torch.Tensor, W: int, band: int,
                     match: int = 2, mismatch: int = -2, gap_open: int = 3,
                     gap_ext: int = 1):
    """Banded affine-gap local alignment scores for a batch, on the device
    of q and t.

    q, t: (B, L) integer codes 0..3; 4 and above (N, padding) score 0
    against anything (the reference's 5th matrix row and column).
    Returns int32 (score (B,), end_i (B,), end_j (B,)): the best cell's
    score and its 1-based query / target end, (0, 0, 0) when nothing
    scores positive.  Ties go to the smallest i, then the smallest j,
    equal to JAX's `banded_sw_affine` at every band."""
    B, L = q.shape
    dev = q.device
    dt = torch.int32
    oe = gap_open + gap_ext
    d_idx = torch.arange(band, dtype=dt, device=dev)
    slope = gap_ext * d_idx
    # substitution score by table: code pair (a, b) at a * 5 + b, each
    # clamped to 4, the one non-ACGT code
    tab = torch.zeros((5, 5), dtype=dt)
    tab[:4, :4] = mismatch
    tab[range(4), range(4)] = match
    tab = tab.reshape(25).to(dev)
    q5 = q.long().clamp(0, 4) * 5
    # t padded with the non-ACGT code on both sides, so row i's band
    # window is tpad[:, i:i + band] (target column j = i + d - W)
    tpad = torch.full((B, L + W + 1 + band), 4, dtype=torch.int64,
                      device=dev)
    tpad[:, W + 1:W + 1 + L] = t.long().clamp(0, 4)
    h = torch.zeros((B, band), dtype=dt, device=dev)
    f = torch.full((B, band), NEG, dtype=dt, device=dev)
    neg = torch.full((B, 1), NEG, dtype=dt, device=dev)
    sc = torch.zeros(B, dtype=dt, device=dev)
    bi = torch.zeros_like(sc)
    bj = torch.zeros_like(sc)
    for i in range(1, L + 1):
        sub = tab[q5[:, i - 1:i] + tpad[:, i:i + band]]
        f = torch.maximum(torch.cat([h[:, 1:], neg], 1) - oe,
                          torch.cat([f[:, 1:], neg], 1) - gap_ext)
        a = torch.maximum(h + sub, f).clamp_min_(0)
        # the band cells outside 1 <= j <= L: d < lo or d >= hi
        lo, hi = max(0, W + 1 - i), min(band, L + W + 1 - i)
        edge = lo > 0 or hi < band
        if edge:
            a[:, :lo] = 0
            a[:, hi:] = 0
        p = torch.cummax(a + slope, 1).values - slope
        h = torch.maximum(a, torch.cat([neg, p[:, :-1]], 1) - oe)
        if edge:
            h[:, :lo] = 0
            h[:, hi:] = 0
            f[:, :lo] = NEG
            f[:, hi:] = NEG
        rb = h.amax(1)
        # the first maximal cell, by value: torch.argmax does not promise
        # the first of tied maxima on every device
        rd = torch.where(h == rb[:, None], d_idx, band).amin(1)
        better = rb > sc
        sc = torch.where(better, rb, sc)
        bi = torch.where(better, i, bi)
        bj = torch.where(better, rd + (i - W), bj)
    none = sc <= 0
    return (sc.masked_fill(none, 0), bi.masked_fill(none, 0),
            bj.masked_fill(none, 0))


def affine_align(q: np.ndarray, t: np.ndarray, W: int, match: int = 2,
                 mismatch: int = -2, gap_open: int = 3, gap_ext: int = 1):
    """Banded affine-gap local alignment with CIGAR, band 2W+1 (the
    `compute_cigar` equivalent; the reference's ssw_use.c:27-54 parameters
    by default), by csrc/affine.cpp on the host.

    Returns (score, (q_beg, q_end, t_beg, t_end), ops) with 0-based
    half-open coordinates and ops [(count, 'M' | 'I' | 'D')], or (0, None,
    None) when nothing scores > 0."""
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    lib = native_build.load("affine", _FUNCS)
    max_ops = 2 * (q.shape[0] + t.shape[0]) + 4
    ops = np.empty(max_ops, dtype=np.uint8)
    lens = np.empty(max_ops, dtype=np.int32)
    out5 = np.zeros(5, dtype=np.int32)
    n = lib.lrm_affine_align(q.ctypes.data, q.shape[0], t.ctypes.data,
                             t.shape[0], W, match, mismatch, gap_open,
                             gap_ext, ops.ctypes.data, lens.ctypes.data,
                             max_ops, out5.ctypes.data)
    if n == -1:
        return 0, None, None
    if n < 0:
        raise RuntimeError(f"lrm_affine_align failed: {n}")
    return (int(out5[0]), tuple(int(x) for x in out5[1:5]),
            [(int(lens[i]), chr(ops[i])) for i in range(n)])
