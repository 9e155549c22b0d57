"""Distributed mapping over the ('data', 'model') mesh (port of
longreadmapper_tpu/parallel/dist.py over torch.distributed).

Reads are split over 'data': each data index runs the single-device step
on its own rows of every chunk part.  The index is replicated on every
rank, or its six gather tables (sa_ctx, sa_hi, lch, lch_hi, text_packed,
text_pair) are row-sharded over 'model' as `ShardedRows`, which stands for
JAX's GSPMD-partitioned gathers: a rank holds one row block of each table,
and a gather is a masked local gather plus one all_reduce over the model
group.  Every rank of a model group holds the same data rows, so it runs
the same step with the same indices and the same host syncs: the step is
replicated across 'model', as JAX's is, and needs no index exchange.

The sensitivity counter is a real collective: each step's mapped-read
count is all_reduce'd over the data group (JAX: a psum over 'data').
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..index.device import DeviceIndex
from ..mapping.pipeline import MapperConfig, map_step

SHARDED_TABLES = ("sa_ctx", "sa_hi", "lch", "lch_hi", "text_packed",
                  "text_pair")
# the integer dtypes that Gloo and NCCL both sum; others widen to int32
_REDUCIBLE = (torch.uint8, torch.int8, torch.int32, torch.int64)


class ShardedRows:
    """Rows [lo, lo + R) of an n-row table padded to M * R rows (R =
    ceil(n / M)), on this rank's device; `t[idx]` gathers any rows of the
    whole table for an integer index tensor of any shape.

    Each rank gathers the rows it owns and zeros elsewhere, then one
    all_reduce(SUM) over the model group adds the M answers.  Exactly one
    rank adds a non-zero value to each element, so the sum is exact for
    every integer dtype, negative int32 words included.  `shape` is the
    unpadded table's: the step clamps its indices to shape[0] - 1 and
    reads no pad row."""

    def __init__(self, host: np.ndarray, part: int, parts: int, pg,
                 device):
        n = host.shape[0]
        R = max(1, -(-n // parts))
        self.lo, self.rows = part * R, R
        block = np.zeros((R,) + host.shape[1:], dtype=host.dtype)
        own = host[self.lo:self.lo + R]      # empty past the last row
        block[:own.shape[0]] = own
        self.local = torch.from_numpy(block).to(device)
        self.shape = torch.Size((n,) + tuple(host.shape[1:]))
        self.group = pg

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def nbytes(self) -> int:
        """The bytes this rank holds: its row block."""
        return self.local.nbytes

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        loc = idx.to(torch.int64) - self.lo
        own = (loc >= 0) & (loc < self.rows)
        got = self.local[loc.clamp(0, self.rows - 1)]
        own = own.reshape(own.shape + (1,) * (got.dim() - own.dim()))
        got = torch.where(own, got, torch.zeros((), dtype=got.dtype,
                                                device=got.device))
        wide = got if got.dtype in _REDUCIBLE else got.to(torch.int32)
        dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=self.group)
        return wide.to(got.dtype)


def shard_index(arrays: dict, mesh, shard_tables: bool, device
                ) -> DeviceIndex:
    """The index on this rank's `device` from its host arrays
    (index.device.load_host_index): replicated, or with the six gather
    tables as ShardedRows over the 'model' axis.  A sharded table uploads
    only this rank's row block; the small tables (packed, occ_samp, c4,
    mta_*) are replicated."""
    if not shard_tables:
        return DeviceIndex.from_arrays(arrays, device)
    m = mesh.get_coordinate()[1]
    M = mesh["model"].size()
    pg = mesh.get_group("model")
    small = {k: (None if k in SHARDED_TABLES else v)
             for k, v in arrays.items()}
    idx = DeviceIndex.from_arrays(small, device)
    for k in SHARDED_TABLES:
        if arrays.get(k) is not None:
            setattr(idx, k, ShardedRows(np.asarray(arrays[k]), m, M, pg,
                                        idx.packed.device))
    return idx


def _valid_count(cfg: MapperConfig, blob: torch.Tensor, lens: torch.Tensor):
    """Mapped reads of a step's blob (the sensitivity metric,
    alnmain.c:541).  Pad rows (lens == 0) never count: a zero-length read
    'aligns' with ed 0."""
    mw = cfg.meta_words
    meta = blob[:, :4 * mw].contiguous().view(torch.int32)
    ed = meta[:, mw - 3]
    found = meta[:, 2 if cfg.pos64 else 1]
    return ((ed >= 0) & (found != 0) & (lens > 0)).sum()


def sharded_map_step(cfg: MapperConfig, mesh):
    """The mesh's step for this rank's rows: `cfg.B` is the rank's share of
    the global batch.  Returns step(idx, codes, codes_rc, lens, limits) ->
    (out, valid): `out` is map_step's, `valid` the GLOBAL mapped-read
    count, all_reduce'd over the data group (the same on every rank).  An
    index from shard_index(..., shard_tables=True) runs its ShardedRows'
    model-group collectives inside map_step; no other argument tells the
    two placements apart."""
    pg = mesh.get_group("data")

    def step(idx, codes, codes_rc, lens, limits):
        out = map_step(cfg, idx, codes, codes_rc, lens, limits)
        valid = _valid_count(cfg, out["blob"], lens)
        dist.all_reduce(valid, op=dist.ReduceOp.SUM, group=pg)
        return out, valid

    return step
