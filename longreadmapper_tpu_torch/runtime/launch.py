"""Multi-process mapping launcher (port of
longreadmapper_tpu/runtime/launch.py over torch.distributed).

One logical mapper runs over every rank of the process group, one device
a rank:

  - `init_distributed` forms the group from the standard launch contract
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, as `torchrun`
    sets them): NCCL for `cuda`, Gloo for `cpu`.  A lone process forms a
    world-1 group through an in-process store, so the collectives run;
    a group the caller made already is left as it is;
  - a ('data', 'model') mesh spans the ranks; each chunk is a GLOBAL
    batch split over 'data' (every process parses the whole FASTQ and
    packs only its own contiguous rows);
  - the index is loaded once per rank, replicated, or with its six gather
    tables row-sharded over 'model' (`shard_index_tables`,
    parallel/dist.ShardedRows), each rank uploading only its row blocks;
  - the sensitivity counter is a collective over 'data', so every rank
    returns the same GLOBAL valid count;
  - the ranks of model index 0 write SAM for their rows to
    `<out>.part<data index>`; rank 0 writes the header.  Record order is
    chunk-major, then data slice within the chunk.

  torchrun --nproc-per-node 2 -m longreadmapper_tpu_torch.cli mapdist \\
      ref.fa reads.fq --out-prefix out.sam --device cpu
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from ..device import pick_device
from ..formats.sam import sam_header
from ..index.device import load_host_index
from ..models.mapper import TorchMapper
from ..parallel.mesh import PG_TIMEOUT_S, make_mesh, rank_device
from ..utils.config import Params, read_params
from ..utils.log import new_logger
from .reads import chunks, load_read_batches


def init_distributed(device="cuda", timeout_s: float = PG_TIMEOUT_S
                     ) -> tuple[int, int, bool]:
    """Join (or form) the default process group for `device`.

    Returns (rank, world size, whether this call formed the group).  With
    WORLD_SIZE > 1 or MASTER_ADDR set, the group forms from the
    environment (env://); else a lone process forms a world-1 group over
    a HashStore.  A CUDA device must exist: the call raises before any
    group forms otherwise."""
    dev = pick_device(rank_device(device))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # no device_id: NCCL's eager binding crashed the second world-1 group
    # of a process on the H100 (torch 2.11); set_device names the card
    kw = dict(timeout=datetime.timedelta(seconds=timeout_s))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 or "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                world_size=world,
                                rank=int(os.environ.get("RANK", "0")), **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return dist.get_rank(), dist.get_world_size(), True


def run_distributed(genome_path: str, reads_path: str,
                    params: Optional[Params] = None,
                    out_prefix: Optional[str] = None, rg_id: int = 0,
                    chunk_b: int = 0, shard_index_tables: bool = False,
                    model_shards: int = 0, slim: bool = False,
                    verbose: bool = True, device="cuda") -> tuple[int, int]:
    """Map `reads_path` with one logical mapper over every rank.  Returns
    the GLOBAL (valid, total), the same on every rank through the
    collective sensitivity counter.

    SAM goes to `<out_prefix>.part<data index>` (stdout when out_prefix
    is None and the world is one process).  `model_shards` sets the
    'model' axis with `shard_index_tables` (default: every rank); the
    'data' axis gets the rest.  A group this call formed is destroyed
    before it returns."""
    rank, world, formed = init_distributed(device)
    try:
        out = _run(genome_path, reads_path, params, out_prefix, rg_id,
                   chunk_b, shard_index_tables, model_shards, slim, verbose,
                   device, rank, world)
        if formed:
            dist.barrier()          # no rank tears down under a peer
        return out
    finally:
        if formed:
            dist.destroy_process_group()


def _run(genome_path, reads_path, params, out_prefix, rg_id, chunk_b,
         shard_index_tables, model_shards, slim, verbose, device, rank,
         world):
    p = params or read_params()
    log = new_logger(verbose=verbose and rank == 0)
    dev = pick_device(rank_device(device))
    n_model = (model_shards or world) if shard_index_tables else 1
    if world % n_model:
        raise ValueError(f"{world} ranks do not split into model shards of "
                         f"{n_model}")
    mesh = make_mesh(n_data=world // n_model, n_model=n_model,
                     device_type=dev.type)
    d, m = mesh.get_coordinate()

    t0 = log.vlog("process %d/%d: %d devices, mesh data=%d model=%d%s",
                  rank, world, world, world // n_model, n_model,
                  " (index tables sharded)" if shard_index_tables else "")
    # rank 0 loads first: a cold load writes the devidx cache, which the
    # other ranks then read instead of racing to write it
    if rank:
        dist.barrier()
    arrays, meta, mta = load_host_index(genome_path, slim=slim,
                                        verbose=verbose and rank == 0)
    if not rank:
        dist.barrier()
    if out_prefix is None and world == 1:
        out, close = sys.stdout, False
    elif m == 0:
        out = open(f"{out_prefix or 'out.sam'}.part{d}", "w")
        close = True
    else:
        out, close = None, False
    if rank == 0:
        out.write(sam_header(mta, rg_id))

    mapper = TorchMapper(arrays, meta, mta, p, chunk_b=chunk_b, device=dev,
                         mesh=mesh, shard_tables=shard_index_tables)
    log.vlog("index loaded in %.2fs (n=%d)", log.elapse(t0), meta.n)
    total = local_total = 0
    try:
        for batch in load_read_batches(reads_path, p.batch_size):
            # every rank walks every GLOBAL chunk; the mapper packs and
            # assembles only this rank's rows of each part
            for text, n, _ in mapper.map_stream_sam(chunks(batch,
                                                           mapper.B)):
                if out is not None:
                    out.write(text)
                local_total += n
            total += len(batch)
    finally:
        if close:
            out.close()
    valid = mapper.valid_global
    if total:
        log.vlog("global sensitivity: %d/%d=%f (process %d wrote %d records)",
                 valid, total, valid / total, rank, local_total)
    return valid, total
