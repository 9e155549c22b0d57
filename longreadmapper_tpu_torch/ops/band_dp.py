"""Wrappers of the hand-written CUDA banded-DP direction kernels
(csrc/band_dp.cu), which replace the TPU kernel
longreadmapper_tpu/ops/band_pallas.py::banded_nw_dirs_vt and, unlike it,
also emit the `nm` group bitmap the column walk needs.

`banded_nw_dirs(q, t, W, band)` has the contract of the plain version
ops/wavefront.banded_nw_dirs_v: (vdirs (L/16, B, band) int32, wcol (L+1, B)
int16, nm (ceil(L/16/32), B, band) int32), the whole pass from row 0.
`banded_nw_dirs_tiles(q, t, W, band, ckpt, T, k0, tiles)` rematerializes
the gact tiles k0 .. k0+tiles-1 at once, tile k entered from its
checkpoint row ckpt[k] at row k*T: the same three outputs with a leading
tile axis; its plain version `banded_nw_dirs_tiles_v` is the loop of
single-tile plain calls.  On a CPU tensor each runs its plain version; on
a CUDA tensor it launches a kernel or raises:
  * the warp-per-read kernel `band_dp` for a whole pass at bands 128, 256
    and 384 (`BANDS`; counted in `banded_nw_dirs.launches`);
  * the CTA-per-read kernel `band_dp_wide`, through its one entry
    `band_dp_tiles` (grid (B, tiles), counted in `band_dp_tiles.launches`),
    for a group of tiles and for a whole pass at every other band up to
    32768, 512 included (one tile of L rows entered from row 0).
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build
from .wavefront import banded_nw_dirs_v, row0

# the warp-per-read kernel's bands on the main path: at 512 band_dp_wide
# is faster (scripts/torch_cluster_sweep.py; PERF.md), and _band_dp
# takes 512 only to measure that
BANDS = (128, 256, 384)
WIDE_MAX_BAND = 32768              # the CTA-per-read kernel: band % 128 == 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCS = {
    "lrm_band_dp": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "lrm_band_dp_tiles": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P],
}


def _check_qt(q, t):
    if q.device.type != "cuda" or t.device != q.device:
        raise ValueError(f"q on {q.device}, t on {t.device}: both must be on "
                         "one CUDA device (or both on the CPU)")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError(f"q, t must be int8, got {q.dtype}, {t.dtype}")
    if t.shape != q.shape or not (q.is_contiguous() and t.is_contiguous()):
        raise ValueError("q, t must be contiguous and of one (B, L) shape")


def banded_nw_dirs(q: torch.Tensor, t: torch.Tensor, W: int, band: int):
    """Banded NW direction sweep: a CUDA kernel on a CUDA tensor, the plain
    version (ops/wavefront.banded_nw_dirs_v) on a CPU tensor."""
    if q.device.type == "cpu" and t.device.type == "cpu":
        return banded_nw_dirs_v(q, t, W, band)
    _check_qt(q, t)
    B, L = q.shape
    if band in BANDS:
        return _band_dp(q, t, W, band)
    h0 = row0(B, L, W, band, q.device)[None]
    return tuple(x[0] for x in band_dp_tiles(q, t, W, band, h0, L, 0, 1))


def _band_dp(q, t, W: int, band: int):
    B, L = q.shape
    if L % 16 or not 0 <= W < band:
        raise ValueError(f"band_dp takes L % 16 == 0, 0 <= W < band; got "
                         f"L={L} W={W} band={band}")
    G = L // 16
    dev = q.device
    vdirs = torch.empty((G, B, band), dtype=torch.int32, device=dev)
    wcol = torch.empty((L + 1, B), dtype=torch.int16, device=dev)
    nm = torch.empty((-(-G // 32), B, band), dtype=torch.int32, device=dev)
    lib = native_build.load("band_dp", _FUNCS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lrm_band_dp(q.data_ptr(), t.data_ptr(), B, L, W, band,
                              vdirs.data_ptr(), wcol.data_ptr(),
                              nm.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"band_dp kernel launch failed: error {err}")
    banded_nw_dirs.launches += 1
    return vdirs, wcol, nm


banded_nw_dirs.launches = 0


def banded_nw_dirs_tiles(q: torch.Tensor, t: torch.Tensor, W: int, band: int,
                         ckpt: torch.Tensor, T: int, k0: int, tiles: int):
    """The gact tiles k0 .. k0+tiles-1 of T rows, tile k entered from
    ckpt[k] = H row k*T: (vdirs (tiles, T/16, B, band) int32, wcol (tiles,
    T+1, B) int16, nm (tiles, ceil(T/16/32), B, band) int32), element k-k0
    of each equal to ops/wavefront.banded_nw_dirs_v(..., h0=ckpt[k],
    i0=k*T, n=T).  One kernel launch on a CUDA tensor, the plain loop on a
    CPU tensor."""
    if q.device.type == "cpu" and t.device.type == "cpu":
        return banded_nw_dirs_tiles_v(q, t, W, band, ckpt, T, k0, tiles)
    return band_dp_tiles(q, t, W, band, ckpt, T, k0, tiles)


def banded_nw_dirs_tiles_v(q, t, W: int, band: int, ckpt, T: int, k0: int,
                           tiles: int):
    """Plain version of banded_nw_dirs_tiles: the loop of single-tile plain
    calls (ops/wavefront.banded_nw_dirs_v), one tile at a time."""
    B, L = q.shape
    G = T // 16
    dev = q.device
    vdirs = torch.empty((tiles, G, B, band), dtype=torch.int32, device=dev)
    wcol = torch.empty((tiles, T + 1, B), dtype=torch.int16, device=dev)
    nm = torch.empty((tiles, -(-G // 32), B, band), dtype=torch.int32,
                     device=dev)
    for y in range(tiles):
        k = k0 + y
        vdirs[y], wcol[y], nm[y] = banded_nw_dirs_v(q, t, W, band,
                                                    h0=ckpt[k], i0=k * T,
                                                    n=T)
    return vdirs, wcol, nm


def band_dp_tiles(q: torch.Tensor, t: torch.Tensor, W: int, band: int,
                  ckpt: torch.Tensor, T: int, k0: int, tiles: int):
    """The CTA-per-read kernel on CUDA tensors: one launch of grid (B,
    tiles), tile k0+y entered from ckpt[k0+y] = H row (k0+y)*T, the entry
    rows read in place from ckpt (>= k0+tiles, B, band) int32.  A whole pass
    is the tile k0 = 0 of T = L rows entered from row 0.  Raises for a shape
    it does not take."""
    _check_qt(q, t)
    B, L = q.shape
    i0 = k0 * T
    if (L % 16 or band % 128 or not 128 <= band <= WIDE_MAX_BAND
            or not 0 <= W < band or T % 16 or T <= 0 or k0 < 0
            or tiles <= 0 or i0 + T * tiles > L):
        raise ValueError(
            f"band_dp_wide takes L % 16 == 0, band % 128 == 0 in [128, "
            f"{WIDE_MAX_BAND}], 0 <= W < band, T a positive multiple of 16 "
            f"and (k0 + tiles) * T <= L; got L={L} W={W} band={band} T={T} "
            f"k0={k0} tiles={tiles}")
    if (ckpt.device != q.device or ckpt.dtype != torch.int32
            or ckpt.dim() != 3 or ckpt.shape[1:] != (B, band)
            or ckpt.shape[0] < k0 + tiles or not ckpt.is_contiguous()):
        raise ValueError(f"ckpt must be a contiguous (>= {k0 + tiles}, {B}, "
                         f"{band}) int32 tensor on {q.device}, got "
                         f"{tuple(ckpt.shape)} {ckpt.dtype} on "
                         f"{ckpt.device}")
    G = T // 16
    dev = q.device
    vdirs = torch.empty((tiles, G, B, band), dtype=torch.int32, device=dev)
    wcol = torch.empty((tiles, T + 1, B), dtype=torch.int16, device=dev)
    nm = torch.empty((tiles, -(-G // 32), B, band), dtype=torch.int32,
                     device=dev)
    lib = native_build.load("band_dp", _FUNCS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lrm_band_dp_tiles(
            q.data_ptr(), t.data_ptr(), ckpt[k0].data_ptr(), B, L, W, band,
            i0, T, tiles, vdirs.data_ptr(), wcol.data_ptr(), nm.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"band_dp_wide kernel launch failed: error {err}")
    band_dp_tiles.launches += 1
    return vdirs, wcol, nm


band_dp_tiles.launches = 0
