"""SAM emission replicating the reference record layout exactly (the port's
copy of longreadmapper_tpu/formats/sam.py: `cigar_string`, `sam_header`,
`sam_record`).

Header (reference alnmain.c:62-75):
  @SQ\tSN:<name>\tLN:<len>       per mta entry
  @RG\tID:accaln<rg_id>\tSM:SM_data
  @PG\tID:accaln\tPN:accaln
`rg_id` is time(NULL) in the reference; here it is a parameter (default 0)
for reproducibility (documented divergence).

Record (alnmain.c:500-525):
  QNAME FLAG RNAME POS(off+1) MAPQ CIGAR RNEXT('*') PNEXT(0) TLEN(0)
  SEQ QUAL ED:I:<ed>
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def cigar_string(ops: Sequence[Tuple[int, str]]) -> str:
    """Run-length ops [(count, op), ...] -> SAM CIGAR string."""
    if not ops:
        return "*"
    return "".join(f"{n}{op}" for n, op in ops)


def sam_header(mta: Iterable, rg_id: int = 0) -> str:
    lines: List[str] = []
    for m in mta:
        lines.append(f"@SQ\tSN:{m.seq_name}\tLN:{m.seq_len}")
    lines.append(f"@RG\tID:accaln{rg_id}\tSM:SM_data")
    lines.append("@PG\tID:accaln\tPN:accaln")
    return "\n".join(lines) + "\n"


def sam_record(qname: str, flag: int, rname: str, off: int, mapq: int,
               cigar: str, seq: str, qual: str, ed: int) -> str:
    return (f"{qname}\t{flag}\t{rname}\t{off + 1}\t{mapq}\t{cigar}\t*\t0\t0\t"
            f"{seq}\t{qual}\tED:I:{ed}\n")
