"""Banded global-alignment DP, plain PyTorch versions (port of
longreadmapper_tpu/ops/wavefront.py: banded_nw_dirs_v with with_nm=True,
banded_nw_scores, banded_nw_ed; and of the vertical row step of
ops/gact.py::_dp_row_step, the tile entry below).

Unit-cost banded Needleman-Wunsch of each read against its same-length
target window.  Band coordinate d = j - i + W; the in-row insertion chain
H(i, j-1) + 1 is an exact min-plus prefix scan, computed in slope form
row = d + cummin(cand - d).  Padding: query pad code 4 never matches
target pad code 5; '$'/out-of-range target positions are 5 too.  Row
state is int32 and clamped to INF every row (a dead lane's values would
pass int16 on long reads otherwise).

These are the plain versions beside the CUDA kernels (ops/band_dp.py,
ops/band_scores.py): the CPU tests hold them to JAX, and the card holds
the kernels to them.  Each counts its calls on CUDA tensors
(`cuda_calls`), which the card's main path must leave at 0.
"""

from __future__ import annotations

import torch

INF = 0x3FFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def row0(B: int, L: int, W: int, band: int, device) -> torch.Tensor:
    """(B, band) int32 DP row 0: H(0, j) = j inside the domain, INF
    outside."""
    j0 = torch.arange(band, dtype=torch.int32, device=device) - W
    return torch.where((j0 >= 0) & (j0 <= L), j0.clamp(min=0), INF).expand(
        B, band).contiguous()


def dp_rows(q, t, W: int, band: int, h0, i0: int, n: int,
            with_dirs: bool):
    """Yields (i, row i, dirs of row i or None) for the global rows
    i0+1 .. i0+n of the banded DP entered from `h0` = row i0.  Row masks
    use the global row i and the global L = q.shape[1], so a tile entered
    from a checkpoint row computes exactly the rows of the whole pass."""
    B, L = q.shape
    dev = q.device
    i32 = torch.int32
    d_idx = torch.arange(band, dtype=i32, device=dev)[None, :]
    # tpad[b, i + d] = t[b, i + d - W - 1], 5 outside the window
    tpad = torch.full((B, L + W + 1 + band), 5, dtype=i32, device=dev)
    tpad[:, W + 1:W + 1 + L] = t.to(i32)
    q32 = q.to(i32)
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    h = h0.to(i32)
    for i in range(i0 + 1, i0 + n + 1):
        sub = (q32[:, i - 1:i] != tpad[:, i:i + band]).to(i32)
        up = torch.cat([h[:, 1:], inf_col], dim=1)
        a = h + sub
        b = up + 1
        row = torch.cummin(torch.minimum(a, b) - d_idx, dim=1).values + d_idx
        j = i + d_idx - W
        row = torch.where((j >= 0) & (j <= L), row.clamp(max=INF), INF)
        dirs = None
        if with_dirs:
            diag_ok = (h < INF) & (a == row)
            dirs = torch.where(diag_ok, 0, torch.where(b == row, 1, 2))
        yield i, row, dirs
        h = row


def banded_nw_dirs_v(q, t, W: int, band: int, h0=None, i0: int = 0,
                     n: int | None = None):
    """q (B, L) query codes (pad 4), t (B, L) target codes (pad/'$' 5);
    L % 16 == 0.  By default the whole pass from JAX's row 0; with `h0`
    (B, band) int32 = H row i0 it is one tile of n rows (i0 % 16 == 0,
    n % 16 == 0), the contract of JAX gact's vertical `_dp_row_step`.

    Returns
      vdirs (n//16, B, band) int32 — word v[g, b, d] packs the 2-bit
            directions (0=M, 1=I, 2=D; tie-break M > I > D, the diagonal
            only from a predecessor < INF) of rows i0+g*16+1 .. +16, row
            i at bit pair (i-1) & 15;
      wcol  (n+1, B) int16 — the band-centre score column of rows
            i0 .. i0+n (wcol[0] = h0[:, W]);
      nm    (ceil(G/32), B, band) int32 — bit g & 31 of word g >> 5 set
            iff vdirs[g, b, d] has a non-M pair.
    """
    if q.device.type == "cuda":
        banded_nw_dirs_v.cuda_calls += 1
    B, L = q.shape
    n = L - i0 if n is None else n
    assert L % 16 == 0 and i0 % 16 == 0 and n % 16 == 0 and i0 + n <= L
    if h0 is None:
        assert i0 == 0
        h0 = row0(B, L, W, band, q.device)
    G = n // 16
    dev = q.device
    vdirs = torch.empty((G, B, band), dtype=torch.int32, device=dev)
    wcol = torch.empty((n + 1, B), dtype=torch.int16, device=dev)
    wcol[0] = h0[:, W].to(torch.int16)
    nm = torch.zeros((-(-G // 32), B, band), dtype=torch.int64, device=dev)
    word = None
    for i, row, dirs in dp_rows(q, t, W, band, h0, i0, n, with_dirs=True):
        r = (i - i0 - 1) & 15
        bits = dirs.to(torch.int32) << (2 * r)
        word = bits if r == 0 else word | bits
        wcol[i - i0] = row[:, W].to(torch.int16)
        if r == 15:
            g = (i - i0 - 1) >> 4
            vdirs[g] = word
            nm[g >> 5] |= (word != 0).to(torch.int64) << (g & 31)
    return vdirs, wcol, to_int32_bits(nm)


banded_nw_dirs_v.cuda_calls = 0


def banded_nw_scores(q, t, W: int, band: int):
    """The banded NW score matrix: H (L+1, B, band) int16, INF outside the
    band or the DP domain, row 0 = |j| (JAX ops/wavefront.banded_nw_scores;
    the TPU kernel ops/wavefront_pallas.banded_nw_scores_pallas)."""
    if q.device.type == "cuda":
        banded_nw_scores.cuda_calls += 1
    B, L = q.shape
    h0 = row0(B, L, W, band, q.device)
    H = torch.empty((L + 1, B, band), dtype=torch.int16, device=q.device)
    H[0] = h0.to(torch.int16)
    for i, row, _ in dp_rows(q, t, W, band, h0, 0, L, with_dirs=False):
        H[i] = row.to(torch.int16)
    return H


banded_nw_scores.cuda_calls = 0


def banded_nw_ed(q, t, lens, W: int, band: int):
    """Edit distances only: (ed (B,) int32, H), ed = H[len_b, b, W]."""
    H = banded_nw_scores(q, t, W, band)
    B = q.shape[0]
    ed = H[lens.long(), torch.arange(B, device=q.device), W].to(torch.int32)
    return ed, H
