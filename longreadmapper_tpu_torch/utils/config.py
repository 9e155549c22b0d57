"""Runtime parameters (the port's copy of
longreadmapper_tpu/utils/config.py: `Params`, `auto_hlen`, `read_params`,
same names, fields and defaults; reference alnmain.h:10-13 and
read_params at alnmain.c:574-588).

The hard-coded tunables of the reference surface here (SURVEY.md §5):
o_ratio=32 (asindex.c:138), hlen=12 (asindex.c:142), csa_ratio=4
(fmidx.c:194), CHUNK_SIZE=500 (alnmain.c:19), ERROR_RATE=0.05
(alnmain.c:21), vote-accept threshold 0.6 (alnmain.c:378), histo bucket
shift 4 (histo.c:27).
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class Params:
    # accaln runtime params (defaults: alnmain.c:577-580)
    batch_size: int = 1000
    seed_len: int = 20
    thres: int = 300  # non-informative seed threshold AND initial histo capacity

    # index-build params
    o_ratio: int = 32          # sampled-Occ stride in the .mfi file format
    hlen: int = 12             # lchash k-mer length (asindex.c:142)
    csa_ratio: int = 4         # sampled-SA stride (fmidx.c:194)

    # pipeline constants
    chunk_size: int = 500      # reads per device chunk (alnmain.c:19)
    error_rate: float = 0.05   # alignment limit = 2*error_rate*len (alnmain.c:21,428)
    accept_score: float = 0.6  # early vote-accept threshold (alnmain.c:378)
    bucket_shift: int = 4      # diagonal quantization (histo.c:27)
    gap_len: int = 1           # seed tiling gap `gl` (alnmain.c:343)

    # divergences from the reference (documented)
    n_seed: int = 0            # RNG seed for N-replacement (reference: time(NULL))
    vote_budget: int = 128     # compacted vote slots per (read, phase);
                               # the per-read overflow flag reports drops


def auto_hlen(n_cat: int) -> int:
    """The one hlen rule (docs/TUNING.md "Choosing hlen"): 14 when the .cat
    length `n_cat` (2*genome + 1) is at least 2,000,000, else 12.

    The CLI passes twice the on-disk FASTA size, so a gzipped genome gets
    the smaller hlen (ROADMAP.md section C); the port matches the JAX
    package's quirk on purpose, so both packages pick the same hlen and
    share one index."""
    return 14 if n_cat >= 2_000_000 else 12


def read_params(path: str = "params") -> Params:
    """Reference `read_params` (alnmain.c:574-588): optional whitespace file
    `batch_size seed_len thres` in the cwd; silent defaults if absent."""
    p = Params()
    if os.path.exists(path):
        with open(path) as f:
            toks = f.read().split()
        if len(toks) >= 3:
            p.batch_size, p.seed_len, p.thres = (int(toks[0]), int(toks[1]),
                                                 int(toks[2]))
    return p
