"""The arithmetic that turns a run's records into metrics: percentiles over
chunks, the union and the gaps of device intervals, kernel time by layer,
and the DP's work and least time.  Metric readers (benchmark/metrics/)
call these on the run's record (a dict, see run.py's `measure`)."""

from __future__ import annotations

import re
import statistics

from . import peaks
from .reference import band_of, bucket_len, first_pass_band


def p95(values) -> float:
    """The 95th percentile of all values (statistics.quantiles, inclusive
    method: no value past the largest)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] between intervals."""
    out, at = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def kernel_base(name: str, table: dict):
    """The table's kernel name that a traced kernel's (demangled) name
    holds as a whole identifier, or None."""
    for k in table:
        if re.search(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])",
                     name):
            return k
    return None


def layer_s(trace: dict, table: dict, layer: str, until=None):
    """Device seconds of the window's kernels that the table puts in
    `layer`, up to `until` seconds into it where given; None when the
    trace holds none of them."""
    names = {k for k, v in table.items() if v == layer}
    lo, hi = trace["window"]
    if until is not None:
        hi = min(hi, until)
    total, seen = 0.0, False
    base = {}
    for name, a, b in trace["kernels"]:
        if name not in base:
            base[name] = kernel_base(name, table)
        if base[name] in names:
            seen = True
            total += max(0.0, min(b, hi) - max(a, lo))
    return total if seen else None


def dp_bound_s(chunks: list):
    """The least seconds of the DP work the window's completed chunks
    needed: every read at its bucket's first-pass band, and each read the
    retry tier re-mapped at the bucket's full band.  A chunk's retried
    reads are counted at its mean read length (the mapper counts them,
    it does not name them); None where it does not count them."""
    cells = nbytes = 0
    for ch in chunks:
        if ch["retried"] is None:
            return None
        L = bucket_len(max(ch["lengths"]))
        c, b = peaks.dp_work(ch["lengths"],
                             [first_pass_band(L)] * len(ch["lengths"]))
        cells, nbytes = cells + c, nbytes + b
        if ch["retried"]:
            mean = sum(ch["lengths"]) / len(ch["lengths"])
            c, b = peaks.dp_work([mean] * ch["retried"],
                                 [band_of(L)] * ch["retried"])
            cells, nbytes = cells + c, nbytes + b
    return peaks.bound_s(cells, nbytes)
