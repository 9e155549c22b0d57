"""The one generator of the benchmark's inputs: a genome laid out as a
configuration states it and a pool of reads as a traffic mix states it,
both from --seed.

The genome (benchmark/configs/<name>.json, key "genome"):
  contigs      [[name, length], ...], the source's
  gc           the source's GC share; contig_gc: {name: share} where a
               contig's differs
  repeats      the source's repeat families, [{"family", "length",
               "copies", "placement", ...}]: each family one random
               consensus, its copies identical, placed
                 "scattered"  at random free places (on "contigs", else on
                              any contig), either orientation
                 "tandem"     head to tail from "at" on "contig"
                 "telomeric"  one copy at each of `copies` distinct contig
                              ends (of "contigs", else of every contig),
                              inward of any family placed there before

The reads (benchmark/traffic/<name>.json): a vectorised, frozen copy of
chip_smoke.py's `make_long_reads` (substitutions, 1-base insertions and
deletions over a planted window, both strands), its rates drawn per read
as a read simulator's documented model draws them:
  lengths      {"mean", "stdev", "min", "max"}: the gamma distribution of
               that mean and deviation, restricted to [min, max]
  identity     {"mean", "max", "stdev"}: a read's identity is max times a
               beta variate of mean mean / max and deviation stdev / max;
               its per-base error rate is 1 - identity
  errors       {"sub", "ins", "dele"}: the shares of the error kinds
  reverse_share  share of reads taken from the reverse strand
  chunk_reads  reads a chunk the stream is fed
  pool_chunks  chunks the pool holds; the window cycles through it
  qual         the quality character of every base
  check        the sample of reads the comparison judges
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
FASTA_WIDTH = 80


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of one --seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64,
                                                         stream]))


@dataclass
class Genome:
    names: list
    lengths: np.ndarray      # (contigs,) int64
    offsets: np.ndarray      # (contigs,) int64 start of each in `codes`
    codes: np.ndarray        # (sum of lengths,) uint8, 0-3 = A C G T
    copies: list             # (family, start, end) in `codes`, a repeat copy


def random_codes(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    """n bases, G + C a share gc of them, A = T and G = C."""
    cum = np.array([(1 - gc) / 2, 0.5, 0.5 + gc / 2], np.float64)
    return np.searchsorted(cum, rng.random(n), side="right").astype(np.uint8)


def _place(codes: np.ndarray, at: int, seq: np.ndarray, reverse: bool):
    codes[at:at + seq.size] = (3 - seq)[::-1] if reverse else seq


def make_genome(spec: dict, seed: int) -> Genome:
    """The genome `spec` (a configuration's "genome") describes."""
    names = [str(c[0]) for c in spec["contigs"]]
    lengths = np.array([int(c[1]) for c in spec["contigs"]], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    rng = rng_for(seed, 1)
    gc = float(spec.get("gc", 0.5))
    codes = np.concatenate([
        random_codes(rng, int(n), float(spec.get("contig_gc", {})
                                        .get(name, gc)))
        for name, n in zip(names, lengths)])
    used = []                                # (family, start, end)
    inward = np.zeros((len(names), 2), np.int64)   # taken at each end
    index = {name: i for i, name in enumerate(names)}

    def free(a, b):
        return all(b <= u or a >= v for _, u, v in used)

    for fam in spec.get("repeats", []):
        n, copies = int(fam["length"]), int(fam["copies"])
        seq = random_codes(rng, n, gc)
        how = fam["placement"]
        if how == "tandem":
            at = offsets[index[fam["contig"]]] + int(fam["at"])
            for k in range(copies):
                _place(codes, at + k * n, seq, False)
            used += [(fam["family"], at + k * n, at + (k + 1) * n)
                     for k in range(copies)]
        elif how == "telomeric":
            pool = [index[c] for c in fam.get("contigs", names)]
            ends = [(c, e) for c in pool for e in (0, 1)]
            for j in rng.choice(len(ends), copies, replace=False):
                c, e = ends[j]
                d = inward[c, e]
                at = (offsets[c] + d if e == 0
                      else offsets[c] + lengths[c] - d - n)
                # the copy reads toward the telomere at either end
                _place(codes, at, seq, e == 0)
                inward[c, e] += n
                used.append((fam["family"], at, at + n))
        elif how == "scattered":
            on = np.isin(names, fam.get("contigs", names))
            room = np.where(on, np.maximum(lengths - n, 0), 0)
            for _ in range(copies):
                while True:
                    c = int(np.searchsorted(np.cumsum(room),
                                            rng.random() * room.sum(),
                                            side="right"))
                    at = int(offsets[c] + rng.integers(0, room[c] + 1))
                    if free(at, at + n):
                        break
                _place(codes, at, seq, bool(rng.random() < 0.5))
                used.append((fam["family"], at, at + n))
        else:
            raise ValueError(f"unknown placement {how!r}")
    return Genome(names, lengths, offsets, codes, used)


def write_fasta(path: str, g: Genome) -> None:
    """FASTA of `g`, FASTA_WIDTH bases a line."""
    with open(path, "wb") as f:
        for name, off, n in zip(g.names, g.offsets, g.lengths):
            f.write(f">{name}\n".encode())
            seq = ACGT[g.codes[off:off + n]]
            full = n // FASTA_WIDTH * FASTA_WIDTH
            rows = np.empty((full // FASTA_WIDTH, FASTA_WIDTH + 1), np.uint8)
            rows[:, :FASTA_WIDTH] = seq[:full].reshape(-1, FASTA_WIDTH)
            rows[:, FASTA_WIDTH] = ord("\n")
            f.write(rows.tobytes())
            if full < n:
                f.write(seq[full:].tobytes() + b"\n")


def draw_lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """n lengths from the gamma distribution of spec's mean and stdev,
    restricted to the whole numbers [min, max]."""
    k = (float(spec["mean"]) / float(spec["stdev"])) ** 2
    theta = float(spec["stdev"]) ** 2 / float(spec["mean"])
    x = np.arange(int(spec["min"]), int(spec["max"]) + 1, dtype=np.float64)
    logp = (k - 1) * np.log(x) - x / theta
    p = np.exp(logp - logp.max())
    return x.astype(np.int64)[
        np.searchsorted(np.cumsum(p / p.sum()), rng.random(n), side="right")
        .clip(0, x.size - 1)]


def draw_identity(rng: np.random.Generator, spec: dict, n: int):
    """n identities: max x Beta(a, b), a and b matching mean / max and
    stdev / max."""
    top = float(spec["max"])
    mu, sd = float(spec["mean"]) / top, float(spec["stdev"]) / top
    common = mu * (1 - mu) / sd ** 2 - 1
    return top * rng.beta(mu * common, (1 - mu) * common, n)


@dataclass
class Pool:
    seqs: list               # read strings, as sequenced
    quals: list
    lengths: np.ndarray      # (reads,) int64
    identity: np.ndarray     # (reads,) float64, as drawn
    origin: np.ndarray       # (reads,) int64 start of its window in codes
    chunk_reads: int

    @property
    def n_chunks(self) -> int:
        return len(self.seqs) // self.chunk_reads

    def chunk(self, c: int) -> range:
        """Read indices of pool chunk c."""
        return range(c * self.chunk_reads, (c + 1) * self.chunk_reads)


def torch_generator(seed: int, stream: int, device):
    """A torch.Generator on `device`, seeded from (seed, stream)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed % 2**64, stream])
                        .generate_state(1, np.uint64)[0]) >> 1)
    return gen


def make_pool(g: Genome, traffic: dict, seed: int, device="cpu") -> Pool:
    """chunk_reads * pool_chunks reads of the traffic mix from `g`, their
    lengths and identities one fixed draw in the seed's order: a
    planted window with room for the read's deletions, substitutions to
    another base, deletions, insertions of a random base after a kept
    one, each at its read's rate, cut to the drawn length, then
    reverse-complemented for the reverse strand.  Contigs are drawn by
    their length.  The per-read draws come from NumPy, the per-base ones
    from a torch generator on `device`, a chunk at a time: one seed gives
    one pool on one kind of device."""
    import torch
    rng = rng_for(seed, 2)
    gen = torch_generator(seed, 5, device)
    B = int(traffic["chunk_reads"])
    n = B * int(traffic["pool_chunks"])
    # every seed draws the same lengths and identities, from a stream of
    # their own, in its own order: the seed moves the reads, not the work
    fixed = rng_for(0, 6)
    order = rng.permutation(n)
    lengths = draw_lengths(fixed, traffic["lengths"], n)[order]
    identity = draw_identity(fixed, traffic["identity"], n)[order]
    share = traffic["errors"]
    err = 1.0 - identity
    sub = err * float(share["sub"])
    p_ins = err * float(share["ins"])
    p_del = err * float(share["dele"])
    reverse = rng.random(n) < float(traffic["reverse_share"])
    # the deletions' mean and eight deviations past it, and a margin
    mean_del = lengths * p_del
    span = (lengths + np.ceil(mean_del + 8 * np.sqrt(mean_del)).astype(
        np.int64) + 64)
    usable = np.maximum(g.lengths - int(span.max()), 0)
    if usable.sum() == 0:
        raise ValueError("every contig is shorter than the longest read")
    contig = np.searchsorted(np.cumsum(usable),
                             rng.random(n) * usable.sum(), side="right")
    pos = (rng.random(n) * (g.lengths[contig] - span)).astype(np.int64)
    start = g.offsets[contig] + pos

    dev = torch.device(device)
    codes = torch.from_numpy(g.codes).to(dev)
    out_codes = np.empty(int(lengths.sum()), np.uint8)
    out_at = np.concatenate([[0], np.cumsum(lengths)])

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for c0 in range(0, n, B):
        sl = slice(c0, c0 + B)
        sp = on(span[sl])
        seg0 = torch.cumsum(sp, 0) - sp
        total = int(span[sl].sum())
        k = torch.arange(total, device=dev)
        src = codes[torch.repeat_interleave(on(start[sl]) - seg0, sp) + k]
        m = torch.rand(total, generator=gen, device=dev, dtype=torch.float64
                       ) < torch.repeat_interleave(on(sub[sl]), sp)
        step = torch.randint(1, 4, (total,), generator=gen, device=dev,
                             dtype=torch.uint8)
        src = torch.where(m, (src + step) % 4, src)
        r = torch.rand(total, generator=gen, device=dev, dtype=torch.float64)
        pd = torch.repeat_interleave(on(p_del[sl]), sp)
        pi = torch.repeat_interleave(on(p_ins[sl]), sp)
        ins = (r >= pd) & (r < pd + pi)
        counts = torch.ones(total, dtype=torch.int64, device=dev)
        counts[r < pd] = 0
        counts[ins] = 2
        mut = torch.repeat_interleave(src, counts)
        # the second copy of each inserting base becomes a random base
        extra = torch.randint(0, 4, (total,), generator=gen, device=dev,
                              dtype=torch.uint8)
        ends = torch.cumsum(counts, 0)
        mut[ends[ins] - 1] = extra[ins]
        got = torch.diff(ends[torch.cumsum(sp, 0) - 1],
                         prepend=torch.zeros(1, dtype=torch.int64,
                                             device=dev))
        ln = on(lengths[sl])
        if bool((got < ln).any()):
            raise ValueError("a read's window ran out of bases")
        mstart = torch.cumsum(got, 0) - got
        o0 = torch.cumsum(ln, 0) - ln
        j = torch.arange(int(lengths[sl].sum()), device=dev) - \
            torch.repeat_interleave(o0, ln)
        rev = torch.repeat_interleave(on(reverse[sl]), ln)
        base = torch.repeat_interleave(mstart, ln)
        take = torch.where(rev, base + torch.repeat_interleave(ln, ln) - 1 - j,
                           base + j)
        out = mut[take]
        out = torch.where(rev, 3 - out, out)
        out_codes[out_at[c0]:out_at[c0 + len(span[sl])]] = out.cpu().numpy()
    text = ACGT[out_codes].tobytes().decode()
    seqs = [text[out_at[i]:out_at[i + 1]] for i in range(n)]
    q = str(traffic.get("qual", "I"))
    quals = [q * int(x) for x in lengths]
    return Pool(seqs, quals, lengths, identity, start, B)
