"""Wrappers of the hand-written CUDA banded-DP direction kernels
(csrc/band_dp.cu), which replace the TPU kernel
longreadmapper_tpu/ops/band_pallas.py::banded_nw_dirs_vt and, unlike it,
also emit the `nm` group bitmap the column walk needs.

`banded_nw_dirs(q, t, W, band[, h0, i0, n])` has the contract of the plain
version ops/wavefront.banded_nw_dirs_v: (vdirs (n/16, B, band) int32,
wcol (n+1, B) int16, nm (ceil(n/16/32), B, band) int32), by default the
whole pass from row 0, or one tile of n rows entered from the row h0 at
global row i0 (the gact rematerialization).  On a CPU tensor it runs the
plain version; on a CUDA tensor it launches a kernel or raises:
  * the warp-per-read kernel `band_dp` for a whole pass at band 128-512
    (counted in `banded_nw_dirs.launches`);
  * the CTA-per-read kernel `band_dp_wide` for every other band up to 16384
    and for tile entries (counted in `band_dp_wide.launches`).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .wavefront import banded_nw_dirs_v, row0

BANDS = (128, 256, 384, 512)       # the warp-per-read kernel
WIDE_MAX_BAND = 16384              # the CTA-per-read kernel: band % 128 == 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCS = {
    "lrm_band_dp": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "lrm_band_dp_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}


def _check_qt(q, t):
    if q.device.type != "cuda" or t.device != q.device:
        raise ValueError(f"q on {q.device}, t on {t.device}: both must be on "
                         "one CUDA device (or both on the CPU)")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError(f"q, t must be int8, got {q.dtype}, {t.dtype}")
    if t.shape != q.shape or not (q.is_contiguous() and t.is_contiguous()):
        raise ValueError("q, t must be contiguous and of one (B, L) shape")


def banded_nw_dirs(q: torch.Tensor, t: torch.Tensor, W: int, band: int,
                   h0: torch.Tensor | None = None, i0: int = 0,
                   n: int | None = None):
    """Banded NW direction sweep: a CUDA kernel on a CUDA tensor, the plain
    version (ops/wavefront.banded_nw_dirs_v) on a CPU tensor."""
    if q.device.type == "cpu" and t.device.type == "cpu":
        return banded_nw_dirs_v(q, t, W, band, h0=h0, i0=i0, n=n)
    _check_qt(q, t)
    B, L = q.shape
    if h0 is None and i0 == 0 and n in (None, L) and band in BANDS:
        return _band_dp(q, t, W, band)
    return band_dp_wide(q, t, W, band, h0, i0, L - i0 if n is None else n)


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
    lib = cuda_build.load("band_dp", _FUNCS)
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


def band_dp_wide(q: torch.Tensor, t: torch.Tensor, W: int, band: int,
                 h0: torch.Tensor | None, i0: int, n: int):
    """The CTA-per-read kernel on CUDA tensors: rows i0+1 .. i0+n entered
    from h0 (B, band) int32 = H row i0 (JAX's row 0 when h0 is None and
    i0 == 0).  Raises for a shape it does not take."""
    _check_qt(q, t)
    B, L = q.shape
    if (L % 16 or band % 128 or not 128 <= band <= WIDE_MAX_BAND
            or not 0 <= W < band or i0 % 16 or n % 16 or n <= 0
            or i0 < 0 or i0 + n > L):
        raise ValueError(
            f"band_dp_wide takes L % 16 == 0, band % 128 == 0 in [128, "
            f"{WIDE_MAX_BAND}], 0 <= W < band, i0 and n multiples of 16 "
            f"with 0 < n, i0 + n <= L; got L={L} W={W} band={band} i0={i0} "
            f"n={n}")
    dev = q.device
    if h0 is None:
        if i0 != 0:
            raise ValueError("band_dp_wide needs an entry row h0 at i0 > 0")
        h0 = row0(B, L, W, band, dev)
    if (h0.device != dev or h0.dtype != torch.int32
            or h0.shape != (B, band) or not h0.is_contiguous()):
        raise ValueError(f"h0 must be a contiguous ({B}, {band}) int32 "
                         f"tensor on {dev}, got {tuple(h0.shape)} "
                         f"{h0.dtype} on {h0.device}")
    G = n // 16
    vdirs = torch.empty((G, B, band), dtype=torch.int32, device=dev)
    wcol = torch.empty((n + 1, B), dtype=torch.int16, device=dev)
    nm = torch.empty((-(-G // 32), B, band), dtype=torch.int32, device=dev)
    lib = cuda_build.load("band_dp", _FUNCS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lrm_band_dp_wide(q.data_ptr(), t.data_ptr(), h0.data_ptr(),
                                   B, L, W, band, i0, n, vdirs.data_ptr(),
                                   wcol.data_ptr(), nm.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"band_dp_wide kernel launch failed: error {err}")
    band_dp_wide.launches += 1
    return vdirs, wcol, nm


band_dp_wide.launches = 0
