"""The table of peaks and the least-time bound of the DP kernels: a frozen
copy of chip_smoke.py's `bound()` and its constants.

HBM_BYTES_S   3.35 TB/s, NVIDIA's data sheet for the H100 SXM.
INT32_OPS_S   132 SMs x 64 int32 lanes x 1.98 GHz = 16.7 Tops/s.  Derived
              from the published architecture (SM count, int32 lanes an
              SM, boost clock), not read off a data sheet: half the lanes
              of the 67 TFLOP/s float32 rate, which counts an FMA as two.
INT_OPS_CELL  a dozen int32 operations a banded-DP cell (substitution
              cost, diagonal, up + 1, two minima, the left chain's slope,
              prefix, + d, mask, clamp, direction).

Work is counted from what the inputs need, not from what a kernel does:
a read of length n aligned in a band of half-width W is n * (2W + 1)
cells, its pad rows and rematerialised tiles are not counted, and its
bytes are the read and its window once each.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
INT_OPS_CELL = 12


def bound_s(cells: int, nbytes: int) -> float:
    """The least seconds of a DP over `cells` cells moving `nbytes`: the
    larger of its operations' and its bytes' time."""
    return max(cells * INT_OPS_CELL / INT32_OPS_S, nbytes / HBM_BYTES_S)


def dp_work(lengths, bands) -> tuple:
    """(cells, bytes) of aligning reads of `lengths` each in its band of
    half-width `bands[i]`: n * (2W + 1) cells, 2n bytes (read and window)."""
    cells = sum(int(n) * (2 * int(w) + 1) for n, w in zip(lengths, bands))
    return cells, 2 * sum(int(n) for n in lengths)
