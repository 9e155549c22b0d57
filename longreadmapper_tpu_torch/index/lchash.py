"""lchash: precomputed SA intervals for all 4^hlen k-mers (port of
longreadmapper_tpu/index/lchash.py), built on the host straight from the
suffix array (`lc_build_from_sa`, a copy), on the host by the reference's
4^hlen backward searches over the FM-index's full rank table
(`lc_build_host`, a copy, the build the others are held to), or on a
torch device by a batched backward search of every k-mer
(`lc_build_device`); the three are byte-identical.  K-mer numbering: the first character occupies the
most-significant 2 bits; absent k-mers store (0, 0)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rank import backward_step
from .fmi import FMIndex

# k-mers a batch of the device build: hlen 14 (4^14 k-mers) in 64
# batches.  On an H100 (700 W) 2^22 built hlen 14 in 3.60-3.90 s against
# 6.06-8.20 at 2^20 and 4.06-4.47 at 2^24 and 2^26 (chip_smoke.py phase 4)
DEVICE_CHUNK = 1 << 22


def lc_build_host(fmi: FMIndex, hlen: int) -> np.ndarray:
    """The reference's lchash build, vectorized over all 4^hlen k-mers:
    step j consumes bits (id >> 2j) & 3 of every k-mer still alive (k <=
    l), from (k, l) = (1, n - 1).  Returns (4^hlen, 2) uint64, (0, 0) for
    absent k-mers."""
    upper = 1 << (2 * hlen)
    ids = np.arange(upper, dtype=np.int64)
    c4 = fmi.c4()
    rank = fmi._full_rank()
    k = np.ones(upper, dtype=np.int64)
    l = np.full(upper, fmi.length - 1, dtype=np.int64)
    for j in range(hlen):
        c = (ids >> (2 * j)) & 3
        active = k <= l
        # occ(c, k - 1) = rank[k]; fmi_aln's step, JAX's expression
        k_new = c4[c] + rank[np.maximum(k, 1) - 1 + 1, c] + 1
        l_new = c4[c] + rank[l + 1, c]
        k = np.where(active, k_new, k)
        l = np.where(active, l_new, l)
    absent = k > l
    out = np.stack([np.where(absent, 0, k), np.where(absent, 0, l)], axis=1)
    return out.astype(np.uint64)


def lc_build_from_sa(sa: np.ndarray, cat_codes: np.ndarray, hlen: int
                     ) -> np.ndarray:
    """O(n*hlen) host build, no FM searches.

    Each suffix's first hlen characters become a base-5 key ('$'/past-end
    = 0 < A=1 < C=2 < G=3 < T=4, i.e. suffix order), non-decreasing along
    the SA; a k-mer's interval is then two binary searches.  Bit-identical
    to the reference's 4^hlen serial backward searches.

    sa: (n,) suffix array of the .cat text; cat_codes: (n,) uint8 codes
    (0..3 = ACGT, 4 = '$').  Returns (4^hlen, 2) uint64.
    """
    n = sa.shape[0]
    kdt = np.int32 if 5 ** hlen < 2**31 else np.int64
    dig = np.where(cat_codes < 4, cat_codes + 1, 0).astype(kdt)
    pw = (5 ** (hlen - 1 - np.arange(hlen))).astype(kdt)
    keys = np.zeros(n, dtype=kdt)
    chunk = 1 << 20
    idt = np.int32 if n < 2**31 else np.int64
    for s in range(0, n, chunk):
        w = sa[s:s + chunk].astype(idt)[:, None] + np.arange(hlen, dtype=idt)
        v = np.where(w < n, dig[np.minimum(w, n - 1)], kdt(0))
        keys[s:s + chunk] = v @ pw
    # k-mer keys by doubling: K_k[i*4 + c] = K_{k-1}[i]*5 + (c+1)
    mkeys = np.arange(1, 5, dtype=kdt)
    for _ in range(hlen - 1):
        mkeys = ((mkeys * kdt(5))[:, None]
                 + np.arange(1, 5, dtype=kdt)[None, :]).reshape(-1)
    lo = np.searchsorted(keys, mkeys, side="left")
    hi = np.searchsorted(keys, mkeys, side="right")
    # reference quirk: the backward search never enters the row of the
    # terminal suffix "P$", so the k-mer at position n-1-hlen is missed;
    # that row sorts first in its run, so bump its lower bound
    term = n - 1 - hlen
    if term >= 0 and np.all(cat_codes[term:term + hlen] < 4):
        kid = 0
        for t in range(hlen):
            kid = (kid << 2) | int(cat_codes[term + t])
        lo[kid] += 1
    absent = lo >= hi
    out = np.stack([np.where(absent, 0, lo), np.where(absent, 0, hi - 1)],
                   axis=1)
    return out.astype(np.uint64)


def lc_build_device(packed, occ_samp, c4, dollar_pos: int, n: int,
                    hlen: int, chunk: int = DEVICE_CHUNK,
                    pos_dtype: torch.dtype | None = None) -> np.ndarray:
    """lchash by a batched backward search of all 4^hlen k-mers, `chunk`
    k-mers a batch, on the device of the index tensors (packed, occ_samp,
    c4: the DeviceIndex fields).  Step j consumes the k-mer's bits
    (id >> 2j) & 3, last character first, from (k, l) = (1, n - 1).
    Returns (4^hlen, 2) uint64, (0, 0) for absent k-mers.

    (k, l) start in occ_samp's dtype, as JAX's lc_build_device, except
    that n >= 2^31 (or `pos_dtype`) seeds them int64: JAX's int32 seed of
    l = n - 1 overflows there, and its index build falls back to the
    host.  The port seeds int64 and never falls back."""
    upper = 1 << (2 * hlen)
    dev = packed.device
    if pos_dtype is None:
        pos_dtype = torch.int64 if n >= 2**31 else occ_samp.dtype
    out = np.empty((upper, 2), dtype=np.uint64)
    for start in range(0, upper, chunk):
        ids = torch.arange(start, min(start + chunk, upper),
                           dtype=torch.int64, device=dev)
        k = torch.ones(ids.shape, dtype=pos_dtype, device=dev)
        l = torch.full(ids.shape, n - 1, dtype=pos_dtype, device=dev)
        for j in range(hlen):
            c = ((ids >> (2 * j)) & 3).to(torch.int32)
            k, l = backward_step(c4, packed, occ_samp, dollar_pos, k, l, c,
                                 k <= l)
        absent = k > l
        kl = torch.stack([torch.where(absent, 0, k),
                          torch.where(absent, 0, l)], dim=1)
        out[start:start + ids.shape[0]] = kl.cpu().numpy()
    return out
