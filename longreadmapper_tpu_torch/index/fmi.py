"""Host-side FM-index: build, serialization and exact-match queries
(numpy).

A copy of longreadmapper_tpu/index/fmi.py's FMIndex and encode_bytes: the
original module cannot be imported without JAX (its package __init__
pulls in the device index).  Build semantics match the reference exactly,
so `.mfi` files interoperate with the JAX package:

  C table   — char counts over text[0 .. n-2] (the final '$' is not
              counted), prefix-summed over all 256 byte values.
  BWT       — bwt[i] = text[SA[i]-1], '$' where SA[i] == 0.
  O table   — per-base counts sampled every `o_ratio` positions, exclusive
              of the sample position; '$' not counted.
  CSA       — SA[i * csa_ratio].

Queries (the reference's fmidx.c:277-331), on the host as in JAX:
  occ_access(c, loc) — #c in bwt[0 .. loc], from a full (n+1, 4) rank
                       table built at first use (32 bytes a position);
  fmi_aln            — backward search k = C[c] + occ(c, k-1) + 1,
                       l = C[c] + occ(c, l), stopping once k > l;
  sa_access          — the RAM-resident SA;
  csa_access         — the LF walk to a sampled row.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..formats.mfi import MfiData, read_mfi, write_mfi
from ..formats.ui40 import read_sa5

# raw byte -> 2-bit code (A0 C1 G2 T3), '$' and others -> 4
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _CODE_LUT[_ch] = _i
    _CODE_LUT[_ch + 0x20] = _i


@dataclass
class FMIndex:
    sa: np.ndarray          # (n,) int64
    c: np.ndarray           # (256,) uint64 raw-char C table
    bwt: np.ndarray         # (n,) uint8 raw BWT bytes ('$' included)
    o_ratio: int
    o: np.ndarray           # (4*(n/o_ratio+1),) uint64 interleaved
    csa_ratio: int
    csa: np.ndarray         # (n/csa_ratio+1,) uint64
    _rank: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def length(self) -> int:
        return int(self.bwt.shape[0])

    @staticmethod
    def build(prefix: str, o_ratio: int = 32, csa_ratio: int = 4,
              sa: Optional[np.ndarray] = None) -> "FMIndex":
        """Build from the text file at `prefix`; builds (and writes `.sa5`
        via index/sa.sa_build) the suffix array when `sa` is not given."""
        text = np.fromfile(prefix, dtype=np.uint8)
        n = text.shape[0]
        if sa is None:
            from .sa import sa_build
            sa = sa_build(prefix)

        counts = np.bincount(text[: n - 1], minlength=256).astype(np.uint64)
        c_tab = np.zeros(256, dtype=np.uint64)
        np.cumsum(counts[:-1], out=c_tab[1:])

        bwt = np.empty(n, dtype=np.uint8)
        nz = sa != 0
        bwt[nz] = text[sa[nz] - 1]
        bwt[~nz] = ord("$")

        # exclusive sampled counts, chunked to bound the one-hot transient
        n_samples = n // o_ratio + 1
        o = np.zeros((n_samples, 4), dtype=np.uint64)
        running = np.zeros(4, dtype=np.uint64)
        chunk_samples = max(1, (1 << 26) // o_ratio)
        for ss in range(1, n_samples, chunk_samples):
            se = min(ss + chunk_samples, n_samples)
            lo, hi = (ss - 1) * o_ratio, min((se - 1) * o_ratio, n)
            codes_c = _CODE_LUT[bwt[lo:hi]]
            m = hi - lo
            oh = np.zeros((m, 4), dtype=np.uint64)
            valid = codes_c < 4
            oh[np.nonzero(valid)[0], codes_c[valid]] = 1
            csum = np.cumsum(oh, axis=0)
            sample_pos = np.minimum(np.arange(ss, se) * o_ratio, n) - lo
            o[ss:se] = running + csum[sample_pos - 1]
            running += csum[m - 1]
        o = o.reshape(-1)

        # the last CSA entry is clamped where the reference reads past the
        # end (that entry is never validly read)
        csa_len = n // csa_ratio + 1
        csa_pos = np.minimum(np.arange(csa_len) * csa_ratio, n - 1)
        csa = sa[csa_pos].astype(np.uint64)

        return FMIndex(sa=np.asarray(sa, dtype=np.int64), c=c_tab, bwt=bwt,
                       o_ratio=o_ratio, o=o, csa_ratio=csa_ratio, csa=csa)

    def write(self, prefix: str) -> None:
        write_mfi(MfiData(c=self.c, o_ratio=self.o_ratio, o=self.o,
                          bwt=self.bwt, csa_ratio=self.csa_ratio,
                          csa=self.csa), prefix)

    @staticmethod
    def read(prefix: str, with_sa: bool = True) -> "FMIndex":
        """Load `.mfi` (+ `.sa5` when `with_sa`)."""
        d = read_mfi(prefix)
        sa = read_sa5(prefix + ".sa5") if with_sa else np.empty(0, np.int64)
        return FMIndex(sa=sa, c=d.c, bwt=d.bwt, o_ratio=d.o_ratio, o=d.o,
                       csa_ratio=d.csa_ratio, csa=d.csa)

    def c4(self) -> np.ndarray:
        """(4,) int64 — C table entries for 'A','C','G','T' raw chars."""
        return self.c[[ord("A"), ord("C"), ord("G"), ord("T")]].astype(
            np.int64)

    def _full_rank(self) -> np.ndarray:
        """(n+1, 4) int64 exclusive rank over the BWT ('$' not counted),
        built at first use and kept."""
        if self._rank is None:
            codes = _CODE_LUT[self.bwt]
            oh = np.zeros((self.length + 1, 4), dtype=np.int64)
            valid = codes < 4
            oh[1:][valid, codes[valid]] = 1
            self._rank = np.cumsum(oh, axis=0)
        return self._rank

    def occ_access(self, code, loc):
        """#occurrences of base `code` in bwt[0 .. loc] inclusive (loc = -1
        reads 0), vectorized over arrays of (code, loc)."""
        return self._full_rank()[np.asarray(loc) + 1, np.asarray(code)]

    def fmi_aln(self, codes: np.ndarray, k: int = 1, l: Optional[int] = None
                ) -> Tuple[int, int, int]:
        """Backward search of `codes` (2-bit, leftmost first) from the
        interval (k, l), (1, n - 1) by default.  Returns (hits, k, l),
        hits = 0 when the interval empties; an N (code >= 4) in the query
        is no hit (undefined in the reference)."""
        kk = int(k)
        ll = self.length - 1 if l is None else int(l)
        c4 = self.c4()
        for i in range(len(codes) - 1, -1, -1):
            c = int(codes[i])
            if c >= 4:
                return 0, kk, ll
            kk, ll = (int(c4[c]) + int(self.occ_access(c, kk - 1)) + 1,
                      int(c4[c]) + int(self.occ_access(c, ll)))
            if kk > ll:
                break
        return (0 if kk > ll else ll - kk + 1), kk, ll

    def sa_access(self, loc):
        return self.sa[loc]

    def csa_access(self, loc: int) -> int:
        """SA[loc] by the LF walk to a sampled row, with the reference's
        '$' early return (the step count) and its bail-out to 0 after 5 *
        csa_ratio steps.

        The LF step is JAX's `c4[ch] + occ(ch, loc)`, not the reference's
        `c[ch] + occ(ch, loc) - 1`: that is right only under its unit
        test's '$'-inclusive C table, and off by one under the production
        C table, which leaves the final '$' out.  So csa_access(i) ==
        SA[i] wherever the walk ends on a sampled row, as in JAX."""
        ratio = self.csa_ratio
        counter = 0
        c4 = self.c4()
        while loc % ratio != 0:
            ch = self.bwt[loc]
            if ch == ord("$"):
                return counter
            code = int(_CODE_LUT[ch])
            loc = int(c4[code]) + int(self.occ_access(code, loc))
            counter += 1
            if counter > 5 * ratio:
                return 0
        return int(self.csa[loc // ratio]) + counter


def encode_bytes(raw: np.ndarray) -> np.ndarray:
    """Raw text bytes -> 2-bit codes (4 for '$'/N/other)."""
    return _CODE_LUT[np.asarray(raw, dtype=np.uint8)]
