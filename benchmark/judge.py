"""The comparison that decides `correct`: each sampled SAM record the timed
path produced, against the plain reference's answer for the same read.

A record is wrong when any of these differs from the reference: its name,
flag (0 / 16 mapped, 4 not), contig, position, MAPQ, ED, or SEQ (the read,
reverse-complemented on the reverse strand); or, for a mapped read, when
its CIGAR is not an alignment of SEQ against the reference's window that
consumes both whole and spells exactly the ED.  The CIGAR is judged by what
it says: any optimal path passes, whatever its tie-breaks.  A record the
stream never returned is wrong.  The one number compared is the count of
wrong records; the comparison is exact, so its limit is 0.
"""

from __future__ import annotations

import re

import numpy as np

from .reference import Expected

_CIGAR = re.compile(r"(\d+)([MID])")
_COMP = str.maketrans("ACGTacgt", "TGCATGCA")
_LUT = np.full(256, 9, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i

FIELDS = ("missing", "name", "flag", "contig", "pos", "mapq", "ed", "seq",
          "cigar")


def cigar_cost(cigar: str, q: np.ndarray, t: np.ndarray):
    """Edits a CIGAR spells aligning q against t, or None when it does not
    consume both exactly or holds anything but M, I and D."""
    ops = _CIGAR.findall(cigar)
    if "".join(n + o for n, o in ops) != cigar:
        return None
    qi = ti = cost = 0
    for n, op in ops:
        n = int(n)
        if op == "M":
            if qi + n > q.size or ti + n > t.size:
                return None
            cost += int(np.count_nonzero(q[qi:qi + n] != t[ti:ti + n]))
            qi += n
            ti += n
        elif op == "I":
            qi += n
            cost += n
        else:
            ti += n
            cost += n
    if qi != q.size or ti != t.size:
        return None
    return cost


def want_seq(seq: str, exp: Expected) -> str:
    return seq.translate(_COMP)[::-1] if (exp.found and exp.strand) else seq


def fields_of(exp: Expected, name: str, seq: str, ref) -> list:
    """The SAM fields an answer `exp` stands for, its CIGAR left as "="
    (the control's records: the reference computes no CIGAR)."""
    if exp.valid:
        flag, mapq, cigar = (16 if exp.strand else 0), 255, "="
    else:
        flag, mapq, cigar = 4, 0, "*"
    return [name, str(flag), ref.names[exp.gi] if exp.found else "*",
            str(exp.off + 1 if exp.found else 1), str(mapq), cigar, "*", "0",
            "0", want_seq(seq, exp), "*", f"ED:I:{exp.ed}"]


def judge_record(fields, name: str, seq: str, exp: Expected, ref,
                 check_cigar: bool = True) -> list:
    """The FIELDS that a record (its tab-split fields, or None when
    missing) gets wrong against `exp`; a mapped record's CIGAR only when
    `check_cigar`."""
    if fields is None or len(fields) < 12:
        return ["missing"]
    bad = []
    wseq = want_seq(seq, exp)
    if exp.valid:
        flag, mapq, ed = (16 if exp.strand else 0), 255, exp.ed
    else:
        flag, mapq, ed = 4, 0, -1
    rname = ref.names[exp.gi] if exp.found else "*"
    pos = exp.off + 1 if exp.found else 1
    if fields[0] != name:
        bad.append("name")
    if fields[1] != str(flag):
        bad.append("flag")
    if fields[2] != rname:
        bad.append("contig")
    if fields[3] != str(pos):
        bad.append("pos")
    if fields[4] != str(mapq):
        bad.append("mapq")
    if fields[11] != f"ED:I:{ed}":
        bad.append("ed")
    if fields[9] != wseq:
        bad.append("seq")
    if exp.valid and check_cigar:
        q = _LUT[np.frombuffer(wseq.encode(), np.uint8)]
        t = ref.cat[exp.loc_fwd:exp.loc_fwd + len(seq)]
        if cigar_cost(fields[5], q, np.where(t < 4, t, 5)) != exp.ed:
            bad.append("cigar")
    elif not exp.valid and fields[5] != "*":
        bad.append("cigar")
    return bad


def judge(records: list, reads: list, expected: list, ref,
          check_cigar: bool = True) -> dict:
    """Counts of wrong fields over the sample, `records_wrong`, the
    number of records with any, and `wrong`, (index, fields) of each.  `records[i]` is the tab-split record the
    stream returned for `reads[i]` = (name, seq), or None."""
    counts = {f: 0 for f in FIELDS}
    wrong = []
    for i, (rec, (name, seq), exp) in enumerate(zip(records, reads,
                                                    expected)):
        bad = judge_record(rec, name, seq, exp, ref, check_cigar)
        for f in bad:
            counts[f] += 1
        if bad:
            wrong.append((i, bad))
    counts["records_wrong"] = len(wrong)
    counts["wrong"] = wrong
    return counts
