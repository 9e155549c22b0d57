"""Wrappers of the hand-written CUDA banded-score kernel
(csrc/band_scores.cu), which replaces the TPU kernel
longreadmapper_tpu/ops/wavefront_pallas.py::banded_nw_scores_pallas.

Two entry points on one kernel (counted together in
`band_scores.launches`):
  * `band_scores(q, t, W, band)` -> H (L+1, B, band) int16, the contract
    of ops/wavefront.banded_nw_scores (JAX's banded_nw_scores);
  * `band_checkpoints(q, t, T, W, band)` -> (ckpt (L/T+1, B, band) int32,
    wcol (L+1, B) int16), the contract of ops/gact.gact_forward: the
    forward pass of the tiled long-read path.
On a CPU tensor each runs its plain version; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .band_dp import WIDE_MAX_BAND, _check_qt
from .gact import gact_forward
from .wavefront import banded_nw_scores

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCS = {"lrm_band_scores": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]}


def _launch(q, t, W: int, band: int, T: int, H, ckpt, wcol):
    B, L = q.shape
    if (band % 128 or not 128 <= band <= WIDE_MAX_BAND
            or not 0 <= W < band):
        raise ValueError(f"band_scores takes band % 128 == 0 in [128, "
                         f"{WIDE_MAX_BAND}] and 0 <= W < band; got W={W} "
                         f"band={band}")
    lib = cuda_build.load("band_scores", _FUNCS)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lrm_band_scores(q.data_ptr(), t.data_ptr(), B, L, W, band,
                                  T, ptr(H), ptr(ckpt), ptr(wcol), stream)
    if err != 0:
        raise RuntimeError(f"band_scores kernel launch failed: error {err}")
    band_scores.launches += 1


def band_scores(q: torch.Tensor, t: torch.Tensor, W: int, band: int):
    """Full banded score matrix H (L+1, B, band) int16."""
    if q.device.type == "cpu" and t.device.type == "cpu":
        return banded_nw_scores(q, t, W, band)
    _check_qt(q, t)
    B, L = q.shape
    H = torch.empty((L + 1, B, band), dtype=torch.int16, device=q.device)
    _launch(q, t, W, band, 0, H, None, None)
    return H


band_scores.launches = 0


def band_checkpoints(q: torch.Tensor, t: torch.Tensor, T: int, W: int,
                     band: int):
    """Checkpointed forward pass: (ckpt (L/T+1, B, band) int32 with ckpt[k]
    = H row k*T, wcol (L+1, B) int16 = H[:, :, W])."""
    if q.device.type == "cpu" and t.device.type == "cpu":
        return gact_forward(q, t, T, W, band)
    _check_qt(q, t)
    B, L = q.shape
    if T <= 0 or T % 16 or L % T:
        raise ValueError(f"band_checkpoints takes T % 16 == 0, L % T == 0; "
                         f"got L={L} T={T}")
    ckpt = torch.empty((L // T + 1, B, band), dtype=torch.int32,
                       device=q.device)
    wcol = torch.empty((L + 1, B), dtype=torch.int16, device=q.device)
    _launch(q, t, W, band, T, None, ckpt, wcol)
    return ckpt, wcol
