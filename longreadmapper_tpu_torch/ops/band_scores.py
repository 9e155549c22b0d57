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
the kernel or raises.  The kernel splits each read over a thread-block
cluster of `ctas` CTAs, by default `cluster_ctas(B, band)` for this card.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build
from .band_dp import WIDE_MAX_BAND, _check_qt
from .gact import gact_forward
from .wavefront import banded_nw_scores

MAX_CTAS = 4                 # csrc/band_row.cuh kMaxCtas
CLUSTER_MIN_BAND = 2048      # narrower bands keep one CTA a read
# clusters of C CTAs an NVIDIA H100 80GB HBM3 (132 SMs) holds at once with
# one CTA an SM (cudaOccupancyMaxActiveClusters; PERF.md)
H100_RESIDENT = {2: 66, 3: 39, 4: 30}
# cluster sizes that beat one CTA a read when all B clusters are resident,
# best first (scripts/torch_cluster_sweep.py; PERF.md)
CLUSTER_CHOICES = (4, 3, 2)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCS = {"lrm_band_scores": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                              _P],
          "lrm_band_scores_clusters": [_I, _I, _I, _I],
          "lrm_meet_probe": [_I, _I, _I, _I, _I, _P, _P]}
_resident: dict = {}


def cluster_ctas(B: int, band: int, resident: dict = H100_RESIDENT) -> int:
    """CTAs a read of `band_scores`'s launch, from the shape alone: one
    below CLUSTER_MIN_BAND, else the first of CLUSTER_CHOICES whose B
    clusters the card holds at once (`resident`: C -> clusters), so that
    the launch runs in one wave; one when none does.  On the H100: a 50 kb
    pass (B 40) takes 2, a pass of at most 39 reads 3, of at most 30 reads
    4, the 10 kb retry (B 200) 1."""
    if band < CLUSTER_MIN_BAND:
        return 1
    for C in CLUSTER_CHOICES:
        if B <= resident.get(C, 0):
            return C
    return 1


def card_resident(dev) -> dict:
    """The card's own `resident` for cluster_ctas (once a device)."""
    key = torch.device(dev).index or 0
    if key not in _resident:
        _resident[key] = {C: resident_clusters(1, 5120, C)
                          for C in range(2, MAX_CTAS + 1)}
    return _resident[key]


def _launch(q, t, W: int, band: int, T: int, H, ckpt, wcol, ctas):
    B, L = q.shape
    if (band % 128 or not 128 <= band <= WIDE_MAX_BAND
            or not 0 <= W < band):
        raise ValueError(f"band_scores takes band % 128 == 0 in [128, "
                         f"{WIDE_MAX_BAND}] and 0 <= W < band; got W={W} "
                         f"band={band}")
    if ctas is None:
        with torch.cuda.device(q.device):
            ctas = cluster_ctas(B, band, card_resident(q.device))
    if not 1 <= ctas <= MAX_CTAS:
        raise ValueError(f"band_scores takes 1 to {MAX_CTAS} CTAs a read, "
                         f"got {ctas}")
    lib = native_build.load("band_scores", _FUNCS)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lrm_band_scores(q.data_ptr(), t.data_ptr(), B, L, W, band,
                                  T, ctas, 0, ptr(H), ptr(ckpt), ptr(wcol),
                                  stream)
    if err != 0:
        raise RuntimeError(f"band_scores kernel launch failed at {ctas} "
                           f"CTAs a read: error {err}")
    band_scores.launches += 1


def band_scores(q: torch.Tensor, t: torch.Tensor, W: int, band: int,
                ctas: int | None = None):
    """Full banded score matrix H (L+1, B, band) int16."""
    if q.device.type == "cpu" and t.device.type == "cpu":
        return banded_nw_scores(q, t, W, band)
    _check_qt(q, t)
    B, L = q.shape
    H = torch.empty((L + 1, B, band), dtype=torch.int16, device=q.device)
    _launch(q, t, W, band, 0, H, None, None, ctas)
    return H


band_scores.launches = 0


def band_checkpoints(q: torch.Tensor, t: torch.Tensor, T: int, W: int,
                     band: int, ctas: int | None = None):
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
    _launch(q, t, W, band, T, None, ckpt, wcol, ctas)
    return ckpt, wcol


def resident_clusters(B: int, band: int, ctas: int) -> int:
    """cudaOccupancyMaxActiveClusters of the kernel's launch at (B, band)
    in clusters of `ctas` > 1, one CTA an SM: how many the card holds at
    once (on the current device)."""
    n = native_build.load("band_scores", _FUNCS).lrm_band_scores_clusters(
        B, band, ctas, 0)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters at B={B} "
                           f"band={band} C={ctas}: error {-n}")
    return n
