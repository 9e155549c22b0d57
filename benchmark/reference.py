"""The plain reference of the mapping a run judges: the reference mapper's
semantics (lisanhu/LongReadMapper alnmain.c:330-527, as the JAX package's
oracle transcribes them) written again in NumPy and plain PyTorch.  It
takes only the genome and the reads, and works out its own text, its own
index of the text's 20-mers and its own alignments; it imports nothing of
the program.

Per read:
  vote     for each of seed_len + gap_len phases, the seeds at j = phase,
           phase + 21, ... (j < len - seed_len) that occur 0 < r < thres
           times in the text add key = position - j to the phase's
           histogram (bucket key >> 4, the bucket's least key, buckets in
           order of first use, occurrences in suffix order); the phase's
           top two buckets accept its top key when (v1 + v2) / (len // 21)
           > 0.6, else its top key joins a cross-phase histogram whose top
           key is the answer (also when the last phase accepts)
  locate   the first contig whose forward or reverse-complement half holds
           the whole read at that key: contig, strand, offset
  align    unit-cost global alignment of the read (reverse-complemented on
           the reverse strand) against the forward window of its length,
           in the band |j - i| <= W, W = max(8, int(0.05 * len * 2)); the
           read maps when that distance is at most int(0.05 * len * 2)

The text is the configuration's contigs, each followed by its reverse
complement, then '$'.  Suffix order among the occurrences of one seed is
the text's suffix order ('$' and the end lowest), worked out by prefix
doubling: copies of a repeat share thousands of characters, so no prefix
of fixed length orders them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GAP_LEN = 1                 # alnmain.c:343
ACCEPT = (3, 5)             # vote accept when (v1 + v2) / seeds > 3/5
BUCKET_SHIFT = 4            # histo.c:27
ERROR_RATE = 0.05           # alnmain.c:21
INF = 1 << 28


def limit_of(n: int) -> int:
    """(int)(ERROR_RATE * len * 2) in C double arithmetic."""
    return int((ERROR_RATE * n) * 2)


def band_of(n: int) -> int:
    return max(8, limit_of(n))


def bucket_len(n: int, minimum: int = 128) -> int:
    """A read length's bucket: powers of two to 1024, then 1024 steps."""
    b = minimum
    while b < n and b < 1024:
        b *= 2
    if b < n:
        b = -(-n // 1024) * 1024
    return b


def first_pass_band(n: int) -> int:
    """Half-width of a long bucket's first pass: half its band, at least
    64 (the tier the full-band retry stands behind)."""
    L = bucket_len(n)
    W = band_of(L)
    return min(W, max(64, W // 2)) if L > 2048 else W


@dataclass
class Expected:
    found: bool
    gi: int
    strand: int
    off: int
    loc_fwd: int
    ed: int          # -1 when not mapped
    valid: bool


def _codes(seq: str) -> np.ndarray:
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
        lut[c + 32] = i
    return lut[np.frombuffer(seq.encode(), np.uint8)]


def suffix_array(digits: torch.Tensor) -> torch.Tensor:
    """The suffix order of a text of digits (0 lowest), the end lower
    still, by prefix doubling: rank by the first 2k characters from the
    ranks by the first k, until every rank differs."""
    n = digits.numel()
    rank = digits.to(torch.int64)
    k = 1
    while True:
        nxt = torch.zeros(n, dtype=torch.int64, device=digits.device)
        nxt[:max(n - k, 0)] = rank[k:] + 1
        key, order = torch.sort(rank * (n + 2) + nxt)
        new = torch.zeros(n, dtype=torch.int64, device=digits.device)
        new[1:] = torch.cumsum((key[1:] != key[:-1]).to(torch.int64), 0)
        rank = torch.empty_like(new)
        rank[order] = new
        if n == 0 or int(new[-1]) == n - 1:
            return order
        k *= 2


class Reference:
    def __init__(self, genome, seed_len: int, thres: int, device):
        self.dev = torch.device(device)
        self.seed_len = seed_len
        self.thres = thres
        self.names = list(genome.names)
        parts = []
        for off, n in zip(genome.offsets, genome.lengths):
            fwd = genome.codes[off:off + n]
            parts += [fwd, (3 - fwd)[::-1]]
        parts.append(np.array([4], np.uint8))          # '$'
        self.cat = np.concatenate(parts)
        self.cat_start = 2 * genome.offsets
        self.cat_len = genome.lengths.copy()
        text = torch.from_numpy(self.cat.astype(np.int64)).to(self.dev)
        digits = torch.where(text < 4, text + 1, 0)
        self.pos = suffix_array(digits)
        # each suffix's first seed_len characters, base 5, in suffix order
        n = digits.numel()
        key = torch.zeros(n, dtype=torch.int64, device=self.dev)
        for k in range(seed_len):
            d = torch.zeros(n, dtype=torch.int64, device=self.dev)
            d[:n - k] = digits[k:]
            key = key * 5 + d
        self.keys = key[self.pos]

    # ------------------------------------------------------------ vote

    def _occurrences(self, reads: list):
        """Per read: (seed j, key) of every occurrence of every informative
        seed, seeds in j order, occurrences in suffix order."""
        sl = self.seed_len
        codes = [_codes(s) for s in reads]
        lens = np.array([len(c) for c in codes], np.int64)
        nseed = np.maximum(lens - sl, 0)
        flat = torch.from_numpy(np.concatenate(codes).astype(np.int64)).to(
            self.dev)
        digit = torch.where(flat < 4, flat + 1, 0)
        bad = (flat >= 4).to(torch.int64)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        jj = np.concatenate([np.arange(m) for m in nseed])
        at = torch.from_numpy(np.repeat(starts, nseed) + jj).to(self.dev)
        pre = torch.zeros(at.numel(), dtype=torch.int64, device=self.dev)
        nbad = torch.zeros_like(pre)
        for k in range(sl):
            pre = pre * 5 + digit[at + k]
            nbad += bad[at + k]
        ok = nbad == 0                                  # no N in the seed
        lo = torch.searchsorted(self.keys, pre)
        hi = torch.searchsorted(self.keys, pre + 1)
        cnt = torch.where(ok, hi - lo, 0)
        use = (cnt > 0) & (cnt < self.thres)
        cnt = torch.where(use, cnt, 0)
        seed_of = torch.repeat_interleave(
            torch.arange(cnt.numel(), device=self.dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(seed_of.numel(), device=self.dev) - first[seed_of]
        occ_pos = self.pos[lo[seed_of] + k]
        seed_of = seed_of.cpu().numpy()
        occ_pos = occ_pos.cpu().numpy()
        read_of = np.repeat(np.arange(len(reads)), nseed)[seed_of]
        j = jj[seed_of]
        split = np.searchsorted(read_of, np.arange(len(reads) + 1))
        return lens, [(j[a:b], occ_pos[a:b] - j[a:b])
                      for a, b in zip(split[:-1], split[1:])]

    @staticmethod
    def _top2(entries):
        """histo_find_2_max over (key, count) entries in order of first
        use: ((key1, v1), (key2, v2)), ties to the earlier entry."""
        s0, s1 = [0, 0], [0, 0]
        for k, v in entries:
            if s1[1] < v and s0[1] < v:
                s1 = s0
                s0 = [k, v]
            elif s1[1] < v and s0[1] >= v:
                s1 = [k, v]
        return s0, s1

    @classmethod
    def _histo(cls, keys: np.ndarray):
        if keys.size == 0:
            return cls._top2([])
        b = keys >> BUCKET_SHIFT
        ub, first, inv = np.unique(b, return_index=True, return_inverse=True)
        cnt = np.bincount(inv)
        least = np.full(ub.size, np.iinfo(np.int64).max)
        np.minimum.at(least, inv, keys)
        order = np.argsort(first, kind="stable")
        return cls._top2(zip(least[order].tolist(), cnt[order].tolist()))

    def _best(self, rlen: int, j: np.ndarray, keys: np.ndarray) -> int:
        phases = self.seed_len + GAP_LEN
        num_seeds = rlen // phases
        ph = j % phases
        order = np.argsort(ph, kind="stable")
        ph, keys = ph[order], keys[order]
        cut = np.searchsorted(ph, np.arange(phases + 1))
        outer = []                     # phase tops, in order
        for it in range(phases):
            (k1, v1), (_, v2) = self._histo(keys[cut[it]:cut[it + 1]])
            if num_seeds > 0:
                if ACCEPT[1] * (v1 + v2) > ACCEPT[0] * num_seeds:
                    if it != phases - 1:
                        return k1
                    break
                if v1 != 0:
                    outer.append(k1)
        (k1, _), _ = self._histo(np.array(outer, np.int64))
        return k1

    def _lookup(self, loc: int, qlen: int):
        for gi, (start, slen) in enumerate(zip(self.cat_start, self.cat_len)):
            start, slen = int(start), int(slen)
            end = start + 2 * slen
            if loc >= start and loc + qlen <= start + slen:
                return True, gi, 0, loc - start, loc
            if loc >= start + slen and loc + qlen <= end:
                off = end - loc - qlen
                return True, gi, 1, off, off + start
        return False, 0, 0, 0, 0

    # ----------------------------------------------------------- align

    def banded_ed(self, qs: list, ts: list, Ws: list) -> np.ndarray:
        """Unit-cost global distance of each q against its t (equal
        lengths) in the band |j - i| <= W, row by row over the batch: a
        row's cell is min(diag + mismatch, up + 1), then the left chain
        min over k <= d of T[k] + (d - k), by a running minimum."""
        dev = self.dev
        B = len(qs)
        lens = np.array([len(q) for q in qs], np.int64)
        Wm = int(max(Ws))
        band = 2 * Wm + 1
        Lm = int(lens.max())
        q = torch.full((B, Lm), 6, dtype=torch.int32)
        tp = torch.full((B, Lm + 2 * Wm + 1), 7, dtype=torch.int32)
        for b in range(B):
            q[b, :lens[b]] = torch.from_numpy(
                np.ascontiguousarray(qs[b], dtype=np.int32))
            tp[b, Wm:Wm + lens[b]] = torch.from_numpy(
                np.ascontiguousarray(ts[b], dtype=np.int32))
        q, tp = q.to(dev), tp.to(dev)
        d = torch.arange(band, device=dev, dtype=torch.int32)
        W = torch.tensor(Ws, dtype=torch.int32, device=dev)[:, None]
        inband = (d[None, :] - Wm).abs() <= W
        j0 = (d - Wm).expand(B, band)
        H = torch.where(inband & (j0 >= 0), j0, INF).to(torch.int32)
        res = torch.full((B,), INF, dtype=torch.int32, device=dev)
        ends = {}
        for b, n in enumerate(lens.tolist()):
            ends.setdefault(n, []).append(b)
        big = torch.tensor(INF, dtype=torch.int32, device=dev)
        for i in range(1, Lm + 1):
            T = H + (tp[:, i - 1:i - 1 + band] != q[:, i - 1:i])
            T[:, :-1] = torch.minimum(T[:, :-1], H[:, 1:] + 1)
            if i <= Wm:
                T[:, :Wm - i] = INF
                T[:, Wm - i] = i
            T = torch.where(inband, T, big)
            H = torch.clamp(torch.cummin(T - d, dim=1).values + d, max=INF)
            if i in ends:
                sel = torch.tensor(ends[i], device=dev)
                res[sel] = H[sel, Wm]
        out = res.cpu().numpy().astype(np.int64)
        out[out >= INF] = -1
        return out

    # ------------------------------------------------------------- map

    def map_reads(self, reads: list) -> list:
        """Expected records of `reads` (strings as sequenced)."""
        lens, occ = self._occurrences(reads)
        found = []
        for r, (j, keys) in enumerate(occ):
            best = self._best(int(lens[r]), j, keys)
            found.append(self._lookup(best, int(lens[r])))
        rows = [i for i, f in enumerate(found) if f[0]]
        eds = {}
        if rows:
            qs, ts, Ws = [], [], []
            for i in rows:
                _, _, strand, _, loc_fwd = found[i]
                n = int(lens[i])
                c = _codes(reads[i])
                qs.append((3 - c)[::-1] if strand else c)
                t = self.cat[loc_fwd:loc_fwd + n]
                ts.append(np.where(t < 4, t, 5))
                Ws.append(band_of(n))
            eds = dict(zip(rows, self.banded_ed(qs, ts, Ws).tolist()))
        out = []
        for i, (ok, gi, strand, off, loc_fwd) in enumerate(found):
            n = int(lens[i])
            ed = eds.get(i, -1)
            if ed < 0 or ed > limit_of(n):
                ed = -1
            out.append(Expected(ok, gi, strand, off, loc_fwd, ed,
                                ok and ed >= 0))
        return out
