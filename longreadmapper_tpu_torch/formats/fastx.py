"""Streaming FASTA/FASTQ parser (kseq.h equivalent; the port's copy of
longreadmapper_tpu/formats/fastx.py: `FastxRecord`, `read_fastx`,
`_encode_lut`).

The reference uses klib's kseq macro parser over gzFile (kseq.h,
instantiated at asindex.c:10 and accaln.h:21).  Behavioral contract:
  - record name = text up to the first whitespace after '>'/'@'
  - multi-line sequences concatenated
  - FASTQ quality read until it reaches sequence length
  - transparent gzip support (detected by magic bytes)
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class FastxRecord:
    name: str
    seq: str
    qual: Optional[str] = None  # None for FASTA

    def __len__(self) -> int:
        return len(self.seq)


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Yield records from a (possibly gzipped) FASTA or FASTQ file."""
    with _open_maybe_gz(path) as f:
        line = f.readline()
        while line:
            line = line.rstrip("\n")
            if not line:
                line = f.readline()
                continue
            if line[0] == ">":
                name = line[1:].split(None, 1)[0] if len(line) > 1 else ""
                chunks = []
                line = f.readline()
                while line and line[0] not in ">@":
                    chunks.append(line.strip())
                    line = f.readline()
                yield FastxRecord(name=name, seq="".join(chunks))
            elif line[0] == "@":
                name = line[1:].split(None, 1)[0] if len(line) > 1 else ""
                chunks = []
                line = f.readline()
                while line and line[0] != "+":
                    chunks.append(line.strip())
                    line = f.readline()
                seq = "".join(chunks)
                # '+' separator line consumed; read qual until len(seq)
                quals = []
                qlen = 0
                while qlen < len(seq):
                    line = f.readline()
                    if not line:
                        break
                    q = line.strip()
                    quals.append(q)
                    qlen += len(q)
                yield FastxRecord(name=name, seq=seq, qual="".join(quals))
                line = f.readline()
            else:
                # skip garbage line
                line = f.readline()


ENCODE_LUT = None


def _encode_lut():
    """(256,) uint8: A/C/G/T (either case) -> 0-3, every other byte -> 4."""
    global ENCODE_LUT
    if ENCODE_LUT is None:
        lut = np.full(256, 4, dtype=np.uint8)  # everything unknown -> 4 (N)
        for i, ch in enumerate("ACGT"):
            lut[ord(ch)] = i
            lut[ord(ch.lower())] = i
        ENCODE_LUT = lut
    return ENCODE_LUT
