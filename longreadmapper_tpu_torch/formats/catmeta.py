""".mta / .cat reference preprocessing (accidx `create_meta` equivalent;
the port's copy of longreadmapper_tpu/formats/catmeta.py: `MtaEntry`,
`create_meta`, `load_mta`, `load_cat`).

Reference semantics (asindex.c:78-116, Notes.txt:6-18):
  .mta — per input sequence: mstring name (u64 len + raw bytes), u64 offset
         into .cat, u64 (size_t) sequence length.
  .cat — per input sequence: the uppercased sequence with N replaced by
         random ACGT, immediately followed by its reverse complement; a final
         '$' terminator after all sequences.  Total = 2*sum(len) + 1 bytes.

Divergence (documented): the reference seeds N-replacement with time(NULL)
(asindex.c:125) so .cat is not reproducible; the seed is the caller's.  The
reverse complement reuses the *same* N-replacement output
(asindex.c:97-102), as in the reference.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

import numpy as np

from ..utils.rng import Lcg48, replace_n
from .fastx import read_fastx

_REVC = None


def _revc_lut():
    global _REVC
    if _REVC is None:
        # revc_mapper is zero-init static (asindex.c:13)
        lut = np.zeros(256, dtype=np.uint8)
        for a, b in zip(b"acgtACGT", b"TGCATGCA"):
            lut[a] = b
        _REVC = lut
    return _REVC


@dataclass
class MtaEntry:
    seq_name: str
    offset: int   # byte offset of the forward strand in .cat
    seq_len: int


def create_meta(fasta_path: str, n_seed: int = 0) -> List[MtaEntry]:
    """Write `<fasta>.mta` and `<fasta>.cat`; returns the mta entries."""
    rng = Lcg48(n_seed)
    entries: List[MtaEntry] = []
    offset = 0
    with open(fasta_path + ".mta", "wb") as mfp, \
            open(fasta_path + ".cat", "wb") as cfp:
        for rec in read_fastx(fasta_path):
            name_b = rec.name.encode("ascii")
            mfp.write(struct.pack("<Q", len(name_b)))
            mfp.write(name_b)
            mfp.write(struct.pack("<Q", offset))
            mfp.write(struct.pack("<Q", len(rec.seq)))

            seq = np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8)
            seq = replace_n(seq, rng)
            # uppercase: ch > 0x60 -> ch - 0x20 (asindex.c:63-67)
            seq = np.where(seq > 0x60, seq - 0x20, seq).astype(np.uint8)
            cfp.write(seq.tobytes())
            rc = _revc_lut()[seq][::-1]
            cfp.write(rc.tobytes())
            offset += 2 * len(rec.seq)
            entries.append(MtaEntry(rec.name, offset - 2 * len(rec.seq),
                                    len(rec.seq)))
        cfp.write(b"$")
    return entries


def load_mta(path: str) -> List[MtaEntry]:
    """Reference `load_mta` (alnmain.c:125-140); <=65535 entries."""
    entries: List[MtaEntry] = []
    with open(path, "rb") as f:
        while len(entries) < 65535:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (nlen,) = struct.unpack("<Q", hdr)
            name = f.read(nlen).decode("ascii")
            (off,) = struct.unpack("<Q", f.read(8))
            (slen,) = struct.unpack("<Q", f.read(8))
            entries.append(MtaEntry(name, off, slen))
    return entries


def load_cat(prefix_cat: str) -> np.ndarray:
    """Load the .cat text as raw bytes (load_file, alnmain.c:237)."""
    return np.fromfile(prefix_cat, dtype=np.uint8)
