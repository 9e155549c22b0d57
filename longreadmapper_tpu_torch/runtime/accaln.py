"""Mapping run — the `accaln` equivalent (port of
longreadmapper_tpu/runtime/accaln.py).

Loads the persisted index to the device, streams read batches through
TorchMapper and writes SAM; logs phase timings and the final sensitivity
valid/total.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, TextIO

from ..formats.sam import sam_header
from ..index.device import load_device_index
from ..models.mapper import TorchMapper
from ..utils.config import Params, read_params
from ..utils.log import new_logger
from .reads import chunks, load_read_batches


def run_mapping(genome_path: str, reads_path: str,
                params: Optional[Params] = None,
                out: Optional[TextIO] = None, rg_id: int = 0,
                chunk_b: int = 0, verbose: bool = True,
                device="cuda", slim: bool = False) -> tuple[int, int]:
    """Map `reads_path` against the index of `genome_path` on `device`
    (the slim index layout when `slim`); SAM to `out` (default stdout).
    Returns (valid, total).  The verbose log ends with the mapper's
    host-phase seconds, its chunk counts and retry counters."""
    p = params or read_params()
    out = out or sys.stdout
    log = new_logger(verbose=verbose)

    log.vlog("Start initialization")
    t0 = log.vlog("loading index artifacts for %s", genome_path)
    idx, meta, mta = load_device_index(genome_path, device, verbose=verbose,
                                       slim=slim)
    log.vlog("index loaded in %.2fs (n=%d, hlen=%d, %s positions, %s, %s)",
             log.elapse(t0), meta.n, meta.hlen, meta.pos_dtype,
             "slim" if meta.slim else "full", device)
    log.vlog("Current settings:")
    log.vlog("batch_size: %d", p.batch_size)
    log.vlog("seed_length: %d", p.seed_len)
    log.vlog("non-informative seeds threshold: %d", p.thres)

    out.write(sam_header(mta, rg_id))

    mapper = TorchMapper(idx, meta, mta, p, chunk_b=chunk_b, device=device)
    total = valid = 0
    for batch in load_read_batches(reads_path, p.batch_size):
        t0 = log.vlog("processing batch of %d reads", len(batch))
        for text, n, v in mapper.map_stream_sam(chunks(batch, mapper.B)):
            out.write(text)
            total += n
            valid += v
        log.vlog("batch done in %.2fs (total %d)", log.elapse(t0), total)

    log.vlog("Done aligning")
    for cfg in mapper.bucket_configs():
        log.vlog("bucket %s", json.dumps(cfg))
    log.vlog("phase_s %s", json.dumps(mapper.phase_s))
    log.vlog("chunks: %d raw-encoded on the device, %d host-encoded",
             mapper.raw_chunks, mapper.host_chunks)
    log.vlog("retried reads %d, overflow reads %d, retried_sat_chunks %d",
             mapper.retried_reads, mapper.overflow_reads,
             mapper.retried_sat_chunks)
    if total:
        log.vlog("Sensitivity: %d/%d=%f", valid, total, valid / total)
    return valid, total
