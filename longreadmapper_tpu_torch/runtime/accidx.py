"""Index build — the `accidx` equivalent (port of the host branch of
longreadmapper_tpu/runtime/accidx.py).

FASTA -> .mta/.cat -> suffix array (.sa5, native SA-IS) -> FM-index (.mfi)
-> lchash (.lch, built from the SA on the host) -> the device-layout cache
(<ref>.cat.devidx/).  All five artifacts and the cache are byte-identical
to the JAX package's.  The accelerator lchash build is not ported
(ROADMAP.md A12), so the host build is the only one.
"""

from __future__ import annotations

from ..formats.catmeta import create_meta, load_cat
from ..formats.lch import write_lch
from ..index.device import _assemble_host_arrays, save_device_cache
from ..index.fmi import FMIndex, encode_bytes
from ..index.lchash import lc_build_from_sa
from ..index.sa import sa_build
from ..utils.config import Params
from ..utils.log import new_logger


def build_index(fasta_path: str, params: Params | None = None,
                verbose: bool = True, devidx: bool = True,
                ram_use: int = 0) -> None:
    p = params or Params()
    log = new_logger(verbose=verbose)

    t0 = log.vlog("create_meta: writing %s.mta / .cat", fasta_path)
    mta = create_meta(fasta_path, n_seed=p.n_seed)
    prefix = fasta_path + ".cat"
    log.vlog("create_meta done in %.2fs (%d sequences)", log.elapse(t0),
             len(mta))

    t0 = log.vlog("sa_build: suffix array -> %s.sa5", prefix)
    sa = sa_build(prefix, ram_use=ram_use)
    log.vlog("sa_build done in %.2fs (n=%d)", log.elapse(t0), sa.shape[0])

    t0 = log.vlog("fmi_build: C/BWT/O/CSA tables (o_ratio=%d)", p.o_ratio)
    fmi = FMIndex.build(prefix, o_ratio=p.o_ratio, csa_ratio=p.csa_ratio,
                        sa=sa)
    fmi.write(prefix)
    log.vlog("fmi_build done in %.2fs", log.elapse(t0))

    t0 = log.vlog("lc_build: %d k-mers (hlen=%d)", 1 << (2 * p.hlen), p.hlen)
    cat = load_cat(prefix)
    kl = lc_build_from_sa(fmi.sa, encode_bytes(cat), p.hlen)
    write_lch(prefix + ".lch", p.hlen, kl)
    log.vlog("lc_build done in %.2fs", log.elapse(t0))

    if devidx:
        t0 = log.vlog("devidx: assembling the device-layout cache")
        arrays, meta = _assemble_host_arrays(fmi, kl, p.hlen, cat, mta)
        save_device_cache(fasta_path, arrays, meta)
        log.vlog("devidx cache written in %.2fs (pos_dtype=%s)",
                 log.elapse(t0), meta.pos_dtype)
