"""Device-resident index: the torch counterpart of
longreadmapper_tpu/index/device.py, with the JAX DeviceIndex's fields:

  packed      (ceil(n/16),) int32   2-bit packed BWT, 16 bases per word
  occ_samp    (ceil(n/16)+1, 4)     exclusive per-word base counts
  c4          (4,)                  C-table entries for A, C, G, T
  sa_ctx      (n, 2) int32          [SA[p] low 32 bits, packed 16-base
                                    left context]; (n,) SA low 32 bits in
                                    the slim layout
  sa_hi       (n,) uint8            SA high byte (pos64 only, else None)
  lch         (4^hlen, 2) int32     (k, l) SA interval per hlen-mer (low
                                    32 bits under pos64)
  lch_hi      (4^hlen, 2) uint8     high bytes of (k, l) (pos64 only)
  text_packed (ceil(n/16),) int32   2-bit text ('$' packed as 0)
  text_pair   (nw+2, 2) int32       adjacent padded text words (slim only)
  mta_start, mta_len (M,)           contig table for seq_lookup

Positions are int32 when the .cat has n < 2^31 positions and 40-bit
split-hi (pos64) otherwise: int32 low words beside uint8 high bytes, joined
to int64 only after a gather, so an index row costs 1 B more instead of 4
(the difference between a human genome fitting on one card or not).
c4 and mta_* are int64 under pos64.  The slim layout drops the context
column of sa_ctx; the step rebuilds each vote's verify window from one
text_pair gather.

The host assembly (`_pack_ctx_words`, `_assemble_host_arrays`) and the
`<genome>.cat.devidx/` cache are numpy copies of the JAX module in the same
on-disk format and with its cache rules, so both packages share one cache.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from ..device import pick_device
from ..formats.catmeta import MtaEntry, load_cat, load_mta
from ..formats.lch import read_lch
from ..ops.rank import occ_samples, pack_codes
from ..utils.log import new_logger
from .fmi import FMIndex, encode_bytes

_ARRAY_NAMES = ("packed", "occ_samp", "c4", "sa_ctx", "sa_hi", "lch",
                "lch_hi", "text_packed", "text_pair", "mta_start", "mta_len")
_CACHE_VERSION = 1


@dataclass(frozen=True)
class IndexMeta:
    n: int            # .cat length including '$'
    dollar_pos: int   # row of '$' in the BWT
    hlen: int
    n_contigs: int
    pos_dtype: str    # 'int32' | 'int64'
    slim: bool = False


@dataclass
class DeviceIndex:
    packed: torch.Tensor
    occ_samp: torch.Tensor
    c4: torch.Tensor
    sa_ctx: torch.Tensor
    sa_hi: Optional[torch.Tensor]
    lch: torch.Tensor
    lch_hi: Optional[torch.Tensor]
    text_packed: torch.Tensor
    text_pair: Optional[torch.Tensor]
    mta_start: torch.Tensor
    mta_len: torch.Tensor

    @staticmethod
    def from_arrays(arrays: dict, device) -> "DeviceIndex":
        """Upload host arrays (the numpy dict of _assemble_host_arrays, the
        devidx cache, or np.asarray of each field of the JAX DeviceIndex)
        to `device`; absent or None arrays stay None.  Arrays are shared
        with numpy where the device is the CPU; the port never writes to
        an index tensor."""
        dev = pick_device(device)

        def up(a):
            if a is None:
                return None
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        with warnings.catch_warnings():
            # read-only (mmap) arrays: torch warns that writes would be UB
            warnings.simplefilter("ignore", UserWarning)
            return DeviceIndex(**{f.name: up(arrays.get(f.name))
                                  for f in fields(DeviceIndex)})


def _pack_ctx_words(sa: np.ndarray, text_codes: np.ndarray) -> np.ndarray:
    """(n,) int32 16-base left-context windows per SA row: text[SA[p]-16+u]
    2-bit packed at bits [2u, 2u+2) for u in 0..15, out-of-range positions
    packed as 0."""
    n = sa.shape[0]
    packed = pack_codes(np.where(text_codes < 4, text_codes, 0)
                        ).view(np.uint32)
    packed = np.concatenate([np.zeros(1, np.uint32), packed,
                             np.zeros(2, np.uint32)])  # +1: word index -1 ok
    out = np.empty(n, dtype=np.int32)
    chunk = 1 << 21
    for s in range(0, n, chunk):
        p = sa[s:s + chunk].astype(np.int64)
        start = p - 16
        w0 = (start >> 4) + 1                 # +1 for the zero pad word
        o = (start & 15).astype(np.uint32)
        lo = packed[np.maximum(w0, 0)] >> (2 * o)
        hi_raw = packed[np.maximum(w0, 0) + 1].astype(np.uint64)
        hi = (hi_raw << (32 - 2 * o)).astype(np.uint64) & 0xFFFFFFFF
        ctx = (lo | hi.astype(np.uint32))
        # for p < 16 only the top 2p bits are real text
        short = p < 16
        if short.any():
            low = (2 * (16 - p.clip(0, 16))).astype(np.uint64)
            keep = ((np.uint64(0xFFFFFFFF) << low) & np.uint64(0xFFFFFFFF)
                    ).astype(np.uint32)
            ctx = np.where(short, ctx & keep, ctx)
        out[s:s + chunk] = ctx.view(np.int32)
    return out


def _text_pair_words(text_packed: np.ndarray) -> np.ndarray:
    """(nw+2, 2) adjacent padded text words for the slim verify window:
    row j = [padded[j], padded[j+1]] with padded = [0] + words + [0, 0],
    _pack_ctx_words' indexing, so one pair gather rebuilds its ctx word."""
    words = text_packed.view(np.uint32)
    padded = np.concatenate([np.zeros(1, np.uint32), words,
                             np.zeros(2, np.uint32)])
    out = np.empty((padded.shape[0] - 1, 2), dtype=np.uint32)
    out[:, 0] = padded[:-1]
    out[:, 1] = padded[1:]
    return out.view(np.int32)


def bwt_arrays(fmi: FMIndex) -> tuple[dict, int]:
    """The BWT-derived device arrays ({packed, occ_samp}) and the '$' row.
    The index build computes them once for the card's lchash build and
    hands them on to _assemble_host_arrays."""
    bwt_codes = encode_bytes(fmi.bwt)
    dollar_pos = int(np.nonzero(bwt_codes == 4)[0][0])
    packed_codes = bwt_codes.copy()
    packed_codes[dollar_pos] = 0
    return dict(packed=pack_codes(packed_codes),
                occ_samp=occ_samples(bwt_codes, dollar_pos)), dollar_pos


def _assemble_host_arrays(fmi: FMIndex, lch_kl: np.ndarray, hlen: int,
                          cat: np.ndarray, mta: list[MtaEntry],
                          force_pos_dtype: str | None = None,
                          slim: bool = False,
                          bwt: tuple[dict, int] | None = None,
                          ) -> tuple[dict, IndexMeta]:
    """Derive the device-layout numpy arrays from the host index
    structures: pos64 when n >= 2^31 or `force_pos_dtype` is 'int64', the
    slim layout when `slim`.  `bwt` is bwt_arrays(fmi) when the caller has
    it already."""
    n = fmi.length
    pos64 = (n >= 2**31) if force_pos_dtype is None \
        else force_pos_dtype == "int64"
    dtype = np.int64 if pos64 else np.int32
    bwt_dev, dollar_pos = bwt if bwt is not None else bwt_arrays(fmi)
    text_codes = encode_bytes(cat)

    sa = fmi.sa
    if slim:
        sa_ctx = (sa & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    else:
        sa_ctx = np.empty((n, 2), dtype=np.int32)
        sa_ctx[:, 0] = (sa & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        sa_ctx[:, 1] = _pack_ctx_words(sa, text_codes)
    sa_hi = (sa >> 32).astype(np.uint8) if pos64 else None

    kl = np.asarray(lch_kl, dtype=np.uint64)
    if pos64:
        lch = (kl & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        lch_hi = (kl >> np.uint64(32)).astype(np.uint8)
    else:
        lch = kl.astype(np.int32)
        lch_hi = None

    text_packed = pack_codes(np.where(text_codes < 4, text_codes, 0))
    arrays = dict(
        packed=bwt_dev["packed"],
        occ_samp=bwt_dev["occ_samp"],
        c4=fmi.c4().astype(dtype),
        sa_ctx=sa_ctx,
        sa_hi=sa_hi,
        lch=lch,
        lch_hi=lch_hi,
        text_packed=text_packed,
        text_pair=_text_pair_words(text_packed) if slim else None,
        mta_start=np.array([m.offset for m in mta], dtype=dtype),
        mta_len=np.array([m.seq_len for m in mta], dtype=dtype),
    )
    meta = IndexMeta(n=n, dollar_pos=dollar_pos, hlen=hlen,
                     n_contigs=len(mta), pos_dtype=np.dtype(dtype).name,
                     slim=slim)
    return arrays, meta


def build_device_index(fmi: FMIndex, lch_kl: np.ndarray, hlen: int,
                       cat: np.ndarray, mta: list[MtaEntry], device,
                       force_pos_dtype: str | None = None,
                       slim: bool = False) -> tuple[DeviceIndex, IndexMeta]:
    """The device index of host index structures on `device`, in the
    layout _assemble_host_arrays picks from `force_pos_dtype` and
    `slim`."""
    arrays, meta = _assemble_host_arrays(fmi, lch_kl, hlen, cat, mta,
                                         force_pos_dtype=force_pos_dtype,
                                         slim=slim)
    return DeviceIndex.from_arrays(arrays, device), meta


def _artifact_fingerprint(genome_path: str) -> dict:
    """Size plus a blake2b of the first and last 1 MiB of each of the 5
    reference artifacts (the JAX package's cache key, unchanged)."""
    import hashlib
    import os as _os

    prefix = genome_path + ".cat"
    fp = {}
    for path in (genome_path + ".mta", prefix, prefix + ".sa5",
                 prefix + ".mfi", prefix + ".lch"):
        st = _os.stat(path)
        h = hashlib.blake2b(digest_size=16)
        with open(path, "rb") as f:
            h.update(f.read(1 << 20))
            if st.st_size > (1 << 20):
                f.seek(max(st.st_size - (1 << 20), 1 << 20))
                h.update(f.read(1 << 20))
        fp[_os.path.basename(path)] = [st.st_size, h.hexdigest()]
    return fp


def _cache_dir(genome_path: str) -> str:
    return genome_path + ".cat.devidx"


def save_device_cache(genome_path: str, arrays: dict,
                      meta: IndexMeta) -> None:
    """Persist the device-layout arrays next to the 5 artifacts, staged in
    a temp dir and renamed in so a crashed save leaves no half cache."""
    import json
    import os as _os
    import shutil
    import tempfile

    d = _cache_dir(genome_path)
    tmp = tempfile.mkdtemp(prefix=".devidx_tmp_",
                           dir=_os.path.dirname(_os.path.abspath(d)) or ".")
    try:
        for k in _ARRAY_NAMES:
            if arrays.get(k) is not None:
                np.save(_os.path.join(tmp, k + ".npy"),
                        np.asarray(arrays[k]))
        info = dict(version=_CACHE_VERSION,
                    meta=dict(n=meta.n, dollar_pos=meta.dollar_pos,
                              hlen=meta.hlen, n_contigs=meta.n_contigs,
                              pos_dtype=meta.pos_dtype, slim=meta.slim),
                    fingerprint=_artifact_fingerprint(genome_path))
        with open(_os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(info, f)
        if _os.path.isdir(d):
            shutil.rmtree(d)
        _os.rename(tmp, d)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _load_device_cache(genome_path: str, force_pos_dtype: str | None,
                       slim: bool = False,
                       ) -> tuple[dict, IndexMeta] | None:
    """The cached device-layout arrays, or None when absent, stale or of
    another layout.  A full-layout cache serves a slim request by deriving
    the slim arrays (the SA column and text_pair); a slim cache cannot
    serve a full request (its ctx words are gone)."""
    import json
    import os as _os

    d = _cache_dir(genome_path)
    mpath = _os.path.join(d, "meta.json")
    if not _os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None
    if info.get("version") != _CACHE_VERSION:
        return None
    meta = IndexMeta(**info["meta"])
    if force_pos_dtype is not None and meta.pos_dtype != force_pos_dtype:
        return None
    if meta.slim and not slim:
        return None
    if info["fingerprint"] != _artifact_fingerprint(genome_path):
        return None
    arrays = {}
    for k in _ARRAY_NAMES:
        p = _os.path.join(d, k + ".npy")
        arrays[k] = np.load(p, mmap_mode="r") if _os.path.exists(p) else None
    if arrays["sa_ctx"] is None:
        return None
    if slim and not meta.slim:
        arrays["sa_ctx"] = np.ascontiguousarray(arrays["sa_ctx"][:, 0])
        arrays["text_pair"] = _text_pair_words(
            np.asarray(arrays["text_packed"]))
        meta = replace(meta, slim=True)
    return arrays, meta


def load_device_index(genome_path: str, device, cache: bool = True,
                      verbose: bool = True,
                      force_pos_dtype: str | None = None, slim: bool = False,
                      ) -> tuple[DeviceIndex, IndexMeta, list[MtaEntry]]:
    """Load the artifact set (.mta/.cat/.sa5/.mfi/.lch) to `device`, via
    the `<genome>.cat.devidx/` cache when its fingerprint and layout match
    (and writing it after a from-artifacts build otherwise).  `slim` loads
    the slim layout; `force_pos_dtype='int64'` forces the pos64 layout on
    any n, and such a load never writes the cache: it would shadow the
    natural layout for every later load of both packages."""
    log = new_logger(verbose=verbose)
    mta = load_mta(genome_path + ".mta")
    if cache:
        hit = _load_device_cache(genome_path, force_pos_dtype, slim=slim)
        if hit is not None:
            arrays, meta = hit
            log.vlog(f"device index cache hit: {_cache_dir(genome_path)}")
            return DeviceIndex.from_arrays(arrays, device), meta, mta

    prefix = genome_path + ".cat"
    fmi = FMIndex.read(prefix, with_sa=True)
    hlen, kl = read_lch(prefix + ".lch")
    cat = load_cat(prefix)
    arrays, meta = _assemble_host_arrays(fmi, kl, hlen, cat, mta,
                                         force_pos_dtype=force_pos_dtype,
                                         slim=slim)
    if cache and force_pos_dtype is None:
        try:
            save_device_cache(genome_path, arrays, meta)
            log.vlog(f"device index cache written: {_cache_dir(genome_path)}")
        except OSError as e:
            log.vlog(f"device index cache write failed (continuing): {e}")
    return DeviceIndex.from_arrays(arrays, device), meta, mta
