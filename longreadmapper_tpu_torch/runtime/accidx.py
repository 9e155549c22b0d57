"""Index build — the `accidx` equivalent (port of
longreadmapper_tpu/runtime/accidx.py).

FASTA -> .mta/.cat -> suffix array (.sa5, native SA-IS in RAM, or by
blocks on disk within `ram_use` bytes) -> FM-index (.mfi)
-> lchash (.lch) -> the device-layout cache (<ref>.cat.devidx/).  The
lchash is built on a torch device by a batched backward search (the card
by default), or on the host from the SA (`device=None`, `index
--host-only`); both give the same table.  All five artifacts and the cache
are byte-identical to the JAX package's.
"""

from __future__ import annotations

import torch

from ..device import pick_device
from ..formats.catmeta import create_meta, load_cat
from ..formats.lch import write_lch
from ..index.device import _assemble_host_arrays, bwt_arrays, \
    save_device_cache
from ..index.fmi import FMIndex, encode_bytes
from ..index.lchash import lc_build_device, lc_build_from_sa
from ..index.sa import sa_build
from ..utils.config import Params
from ..utils.log import new_logger


def build_index(fasta_path: str, params: Params | None = None,
                verbose: bool = True, devidx: bool = True,
                ram_use: int = 0, device: str | None = "cuda") -> None:
    """Build the five artifacts (and the devidx cache when `devidx`).
    `ram_use` > 0 bounds the suffix-array build's working set (bytes;
    index/sa.py::sa_build).  `device` is the torch device of the lchash
    build; None builds it on the host from the suffix array."""
    p = params or Params()
    log = new_logger(verbose=verbose)
    dev = None if device is None else pick_device(device)

    t0 = log.vlog("create_meta: writing %s.mta / .cat", fasta_path)
    mta = create_meta(fasta_path, n_seed=p.n_seed)
    prefix = fasta_path + ".cat"
    log.vlog("create_meta done in %.2fs (%d sequences)", log.elapse(t0),
             len(mta))

    t0 = log.vlog("sa_build: suffix array -> %s.sa5", prefix)
    sa = sa_build(prefix, ram_use=ram_use, log=log.vlog)
    log.vlog("sa_build done in %.2fs (n=%d)", log.elapse(t0), sa.shape[0])

    t0 = log.vlog("fmi_build: C/BWT/O/CSA tables (o_ratio=%d)", p.o_ratio)
    fmi = FMIndex.build(prefix, o_ratio=p.o_ratio, csa_ratio=p.csa_ratio,
                        sa=sa)
    fmi.write(prefix)
    log.vlog("fmi_build done in %.2fs", log.elapse(t0))

    cat = load_cat(prefix)
    # the BWT-derived arrays serve the device build and the devidx cache
    bwt = bwt_arrays(fmi) if (devidx or dev is not None) else None
    t0 = log.vlog("lc_build: %d k-mers (hlen=%d) on %s", 1 << (2 * p.hlen),
                  p.hlen, "the host" if dev is None else dev)
    if dev is None:
        kl = lc_build_from_sa(fmi.sa, encode_bytes(cat), p.hlen)
    else:
        arrays, dollar_pos = bwt
        n = fmi.length
        c4 = fmi.c4().astype("int64" if n >= 2**31 else "int32")
        kl = lc_build_device(
            torch.from_numpy(arrays["packed"]).to(dev),
            torch.from_numpy(arrays["occ_samp"]).to(dev),
            torch.from_numpy(c4).to(dev), dollar_pos, n, p.hlen)
    write_lch(prefix + ".lch", p.hlen, kl)
    log.vlog("lc_build done in %.2fs", log.elapse(t0))

    if devidx:
        t0 = log.vlog("devidx: assembling the device-layout cache")
        arrays, meta = _assemble_host_arrays(fmi, kl, p.hlen, cat, mta,
                                             bwt=bwt)
        save_device_cache(fasta_path, arrays, meta)
        log.vlog("devidx cache written in %.2fs (pos_dtype=%s)",
                 log.elapse(t0), meta.pos_dtype)
