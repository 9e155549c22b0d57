"""Seeded drand48-family RNG for reproducible N->ACGT replacement (the
port's copy of longreadmapper_tpu/utils/rng.py::Lcg48, replace_n; same
names, same draws, so a `.cat` written by either package is byte-identical).

The reference replaces N bases in the genome with random ACGT drawn from
`lrand48()` via `_dna_rand_ch()` (reference asindex.c:37-60), seeded
with `srand48(time(NULL))` (asindex.c:125) — i.e. NOT reproducible across
runs.  The build makes the seed an explicit flag (default 0) and documents
this as an intentional divergence.

`_dna_rand_ch` consumption pattern replicated exactly (asindex.c:37-50):
one 31-bit lrand48 value serves 17 2-bit samples at shift positions
0,2,...,30,32 — where the `val >> 32` on an int32 is C UB that x86 resolves
as `val >> 0`; the x86 behavior is replicated (shift count mod 32).
"""

from __future__ import annotations

import numpy as np

_M48 = (1 << 48) - 1
_A = 0x5DEECE66D
_C = 0xB


class Lcg48:
    """drand48-family 48-bit LCG.

    `srand48(seed)` semantics: state = (seed << 16) | 0x330E.
    `lrand48()` returns the top 31 bits of the next state.
    """

    def __init__(self, seed: int = 0):
        self.state = ((seed & 0xFFFFFFFF) << 16) | 0x330E
        # _dna_rand_ch static state (asindex.c:38-39)
        self._val = 0
        self._pos = -1

    def lrand48(self) -> int:
        self.state = (_A * self.state + _C) & _M48
        return self.state >> 17  # 31-bit non-negative

    def dna_rand_ch(self) -> int:
        """2-bit random base code (asindex.c:37-50, x86 shift semantics)."""
        if self._pos < 0:
            self._val = self.lrand48()
            self._pos = 0
        elif self._pos < 31:
            self._pos += 2
        else:
            self._val = self.lrand48()
            self._pos = 0
        return (self._val >> (self._pos % 32)) & 0x3


def replace_n(seq: np.ndarray, rng: Lcg48) -> np.ndarray:
    """Replace N/n bytes with random ACGT (asindex.c:53-60).

    `seq` is a uint8 byte array of the raw FASTA sequence. Returns a copy.
    """
    out = seq.copy()
    is_n = (out == ord("N")) | (out == ord("n"))
    idxs = np.nonzero(is_n)[0]
    if idxs.size:
        alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
        draws = np.fromiter(
            (rng.dna_rand_ch() for _ in range(idxs.size)), dtype=np.int64,
            count=idxs.size)
        out[idxs] = alpha[draws]
    return out
