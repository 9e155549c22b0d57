"""The mapping step's glue around the DP and the walks (port of the parts
of longreadmapper_tpu/mapping/pipeline.py::make_map_step that XLA fuses
into the jitted step; none is a pallas_call):

  encode_raw(raw, L0)            -> (codes, codes_rc): raw_step's encode
  locate_window(cfg, idx, loc, lens, codes, codes_rc)
                                 -> (found, gi, strand, off, loc_fwd,
                                     safe_loc, q, t): the contig of each
                                    read's best diagonal (_seq_lookup), the
                                    read on its strand and its target window
  lanes(wcol, lens, limit, found, overflow, Wp, narrow)
                                 -> (ed_raw, band_short, overflow, lens_tb):
                                    the walk's inputs
  pack(cfg, best, found, gi, strand, off, ed_raw, limit, band_short,
       overflow, run_units, saturated)
                                 -> dict(blob, ops_tail): the step's output

On a CUDA tensor each launches its hand-written kernel in csrc/step.cu
(encode_kernel, locate_window_kernel, lanes_kernel, pack_kernel), counted
in `<wrapper>.launches`, and raises on inputs the kernel does not take; on
a CPU tensor each runs its plain version (`<name>_plain`: the step's
PyTorch ops, whose `cuda_calls` count calls on the card, which the card's
map path leaves at 0).  Over a row-sharded text (parallel/dist.py's
ShardedRows) locate_window launches twice: the locate and the window's
word indices, then, after the collective has gathered the words, the
window.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build
from .seed_vote import _call, _check, _ptr, _sharded, _stream

I32 = torch.int32
_STAGE_ALL, _STAGE_LOCATE, _STAGE_WINDOW = 0, 1, 2


# ------------------------------------------------------ the plain versions

def encode_raw_plain(raw, L0: int):
    """(codes, codes_rc) of a (B, L) uint8 ASCII chunk whose reads are all
    L0 long (pad bytes 0): a/c/g/t of either case -> 0-3, every other byte
    -> 4, as the host encode's table; the reverse complement front-aligned
    with pad 4.  L0 comes from the host, so the roll costs no sync."""
    if raw.device.type == "cuda":
        encode_raw_plain.cuda_calls += 1
    u = raw | 32                                   # fold ASCII case
    codes = torch.full_like(raw, 4, dtype=torch.int8)
    for c, ch in enumerate(b"acgt"):
        codes = torch.where(u == ch, c, codes)
    comp = torch.where(codes < 4, 3 - codes, codes)
    # the flipped row holds the read at [L - L0, L); rolling it left by
    # L - L0 front-aligns it and wraps the leading pad 4s to the tail
    codes_rc = torch.roll(comp.flip(1), L0 - raw.shape[1], dims=1)
    return codes, codes_rc


encode_raw_plain.cuda_calls = 0


def _seq_lookup(idx, loc, qlen):
    """First contig whose forward or reverse half fully contains
    [loc, loc+qlen), in the contig table's position dtype (int64 under
    pos64).  Returns (found, gi, strand, off, loc_fwd)."""
    pdt = idx.mta_start.dtype
    start = idx.mta_start[None, :]
    slen = idx.mta_len[None, :]
    end = start + 2 * slen
    loc_ = loc.to(pdt)[:, None]
    q_ = qlen.to(pdt)[:, None]
    fwd = (loc_ >= start) & (loc_ + q_ <= start + slen)
    rev = (loc_ >= start + slen) & (loc_ + q_ <= end)
    hit = fwd | rev
    found = hit.any(dim=1)
    gi = hit.to(I32).argmax(dim=1)
    g_start = idx.mta_start[gi]
    g_end = g_start + 2 * idx.mta_len[gi]
    strand = rev.gather(1, gi[:, None])[:, 0] & found
    off = torch.where(strand, g_end - loc.to(pdt) - qlen.to(pdt),
                      loc.to(pdt) - g_start)
    loc_fwd = torch.where(strand, off + g_start, loc.to(pdt))
    return found, gi.to(I32), strand, off, loc_fwd


def _target_windows(cfg, idx, safe_loc):
    """(B, L) int8 target codes at [safe_loc, safe_loc + L) from the 2-bit
    packed text: L/16 + 1 words per read realigned by the sub-word offset;
    '$' (position n-1) and out-of-range positions become 5."""
    B, L = cfg.B, cfg.L
    nwords = L // 16
    dev = safe_loc.device
    tp = idx.text_packed
    w0 = (safe_loc >> 4).to(torch.int64)
    o = (safe_loc & 15).to(torch.int64)[:, None]
    # JAX reads zero pad words past the end; those positions are >= n and
    # masked to 5 below, so a clamped index reads an equivalent word
    widx = (w0[:, None] + torch.arange(nwords + 1, device=dev)[None, :]
            ).clamp(0, tp.shape[0] - 1)
    words = tp[widx].to(torch.int64) & 0xFFFFFFFF
    lo = words[:, :-1] >> (2 * o)
    hi = (words[:, 1:] << (32 - 2 * o)) & 0xFFFFFFFF     # 0 when o == 0
    aligned = lo | hi                                    # (B, nwords)
    shifts = 2 * torch.arange(16, device=dev)
    t = ((aligned[:, :, None] >> shifts) & 3).reshape(B, L)
    gpos = safe_loc[:, None].to(torch.int64) + torch.arange(L, device=dev)
    return torch.where(gpos >= cfg.n - 1, 5, t).to(torch.int8)


def locate_window_plain(cfg, idx, loc, lens, codes, codes_rc):
    """Plain version of locate_window: _seq_lookup, the clamped window
    start, the strand select of q and _target_windows."""
    if loc.device.type == "cuda":
        locate_window_plain.cuda_calls += 1
    found, gi, strand, off, loc_fwd = _seq_lookup(idx, loc, lens)
    safe_loc = torch.where(found, loc_fwd, 0).clamp(0, cfg.n - 1)
    # reverse-strand reads align their reverse complement
    q = torch.where(strand[:, None], codes_rc, codes).contiguous()
    t = _target_windows(cfg, idx, safe_loc)
    return found, gi, strand, off, loc_fwd, safe_loc, q, t


locate_window_plain.cuda_calls = 0


def lanes_plain(wcol, lens, limit, found, overflow, Wp: int, narrow: bool):
    """Plain version of lanes: each lane's ed' from the DP's centre column
    (L+1, B) at its length, its band-short flag, the overflow word with
    bit 2, and the walk's lengths (0: the lane does not walk)."""
    if wcol.device.type == "cuda":
        lanes_plain.cuda_calls += 1
    bidx = torch.arange(wcol.shape[1], device=wcol.device)
    overflow = overflow.to(I32)
    ed_raw = wcol[lens.long(), bidx].to(I32)
    if narrow:
        # narrow first pass: values below Wp are exact; lanes whose ed'
        # reaches it (and whose limit the narrow band cannot certify) flag
        # bit 2 for the full-band retry and skip their walk here
        band_short = found & (ed_raw >= Wp) & (limit >= Wp)
        overflow = overflow | torch.where(band_short, 4, 0).to(I32)
    else:
        band_short = torch.zeros_like(found)
    # dead lanes (unmapped / over-limit: CIGAR '*') skip their walk
    alive = found & (ed_raw <= limit) & ~band_short
    lens_tb = torch.where(alive, lens, 0)
    return ed_raw, band_short, overflow, lens_tb


lanes_plain.cuda_calls = 0


def pack_head(cfg, K: int) -> int:
    """The eager head's bytes of a K-byte run row: all of it on the gact
    path, else OPS_HEAD_COLS rounded down to whole entries."""
    if cfg.use_gact:
        return K          # long reads need ~2 entries per indel: all eager
    head = min(cfg.OPS_HEAD_COLS, K)
    return head - head % cfg.tb_entry_bytes


def pack_plain(cfg, best, found, gi, strand, off, ed_raw, limit, band_short,
               overflow, run_units, saturated=None):
    """Plain version of pack: the meta words, the pad-sorted run entries,
    the blob and the tail."""
    if run_units.device.type == "cuda":
        pack_plain.cuda_calls += 1
    B = run_units.shape[0]
    if saturated is not None:
        # a saturated shared run buffer can corrupt any lane's CIGAR: bit 1
        # sends the chunk to the mapper's saturation tier (a device-side
        # select: the host reads the flag with the blob)
        overflow = overflow | torch.where(saturated, 2, 0).to(I32)
    K = cfg.tb_entry_bytes * run_units.shape[1]
    # a bit-2 lane's ed' is only an upper bound: never report it
    ed = torch.where((ed_raw <= limit) & ~band_short, ed_raw, -1)

    if cfg.pos64:
        # best and off as little-endian [lo, hi] int32 pairs
        b2 = best.to(torch.int64).contiguous().view(I32).reshape(B, 2)
        o2 = off.to(torch.int64).contiguous().view(I32).reshape(B, 2)
        meta = torch.stack([b2[:, 0], b2[:, 1], found.to(I32), gi,
                            strand.to(I32), o2[:, 0], o2[:, 1], ed, limit,
                            overflow], dim=1)
    else:
        meta = torch.stack([best.to(I32), found.to(I32), gi,
                            strand.to(I32), off.to(I32), ed, limit,
                            overflow], dim=1)
    # pad entries (op 3) to the back, path order kept (stable), then the
    # int16/int32 entries as little-endian bytes
    is_pad = ((run_units & 3) == 3).to(torch.int8)
    _, order = torch.sort(is_pad, dim=1, stable=True)
    compact = run_units.gather(1, order).contiguous().view(torch.int8)
    head = pack_head(cfg, K)
    meta_bytes = meta.contiguous().view(torch.int8).reshape(
        B, 4 * cfg.meta_words)
    blob = torch.cat([meta_bytes, compact[:, :head]], dim=1)
    return dict(blob=blob, ops_tail=compact[:, head:K])


pack_plain.cuda_calls = 0


# ------------------------------------------------------------- the kernels

class EncodeArgs(ctypes.Structure):
    """csrc/step.cu::EncodeArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("raw", "codes", "codes_rc")
                ] + [(k, ctypes.c_int64) for k in ("B", "L", "L0")]


class LocateArgs(ctypes.Structure):
    """csrc/step.cu::LocateArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("loc", "lens", "codes", "codes_rc", "start", "slen", "text",
                 "found", "gi", "strand", "off", "loc_fwd", "safe_loc",
                 "widx", "q", "t")] + [
        (k, ctypes.c_int64) for k in
        ("B", "L", "M", "n", "ntext", "p64", "loc64", "stage")]


class LanesArgs(ctypes.Structure):
    """csrc/step.cu::LanesArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("wcol", "lens", "limit", "found", "ovf_in", "ed_raw",
                 "band_short", "overflow", "lens_tb")] + [
        (k, ctypes.c_int64) for k in ("B", "L", "Wp", "narrow")]


class PackArgs(ctypes.Structure):
    """csrc/step.cu::PackArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("best", "found", "gi", "strand", "off", "ed_raw", "limit",
                 "band_short", "overflow", "saturated", "runs", "blob",
                 "tail")] + [
        (k, ctypes.c_int64) for k in
        ("B", "R", "eb", "head", "pos64", "best64", "off64")]


_ARGS = [ctypes.c_void_p, ctypes.c_void_p]
STEP_FUNCS = {"lrm_encode": _ARGS, "lrm_locate_window": _ARGS,
              "lrm_lanes": _ARGS, "lrm_pack": _ARGS}
_POS = (I32, torch.int64)


def _need(name: str, t, dtype, shape) -> None:
    """Raise unless `t` has the dtype (one of a tuple) and shape given."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)}; needs "
                        f"{' or '.join(map(str, dtypes))} {tuple(shape)}")


def _aligned(name: str, t) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads and writes 16 bytes at "
                         "a time and needs a 16-byte aligned tensor")


def _lib():
    return native_build.load("step", STEP_FUNCS)


def encode_raw(raw, L0: int):
    """(codes, codes_rc), each (B, L) int8, of a (B, L) uint8 ASCII chunk
    of reads L0 long: one launch of encode_kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if raw.device.type == "cpu":
        return encode_raw_plain(raw, L0)
    with torch.cuda.device(raw.device):
        return _encode_run(_lib(), _stream(raw.device), raw, L0)


def _encode_run(lib, stream, raw, L0: int):
    """encode_raw through `lib`'s lrm_encode on `stream`."""
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise TypeError(f"raw must be (B, L) uint8, got {raw.dtype} "
                        f"{tuple(raw.shape)}")
    B, L = raw.shape
    if not 0 <= L0 <= L:
        raise ValueError(f"encode_raw: L0 {L0} outside [0, {L}]")
    dev = raw.device
    raw = raw.contiguous()
    codes = torch.empty((B, L), dtype=torch.int8, device=dev)
    codes_rc = torch.empty((B, L), dtype=torch.int8, device=dev)
    _call(lib, "lrm_encode", EncodeArgs(
        raw=raw.data_ptr(), codes=codes.data_ptr(),
        codes_rc=codes_rc.data_ptr(), B=B, L=L, L0=L0), stream)
    encode_raw.launches += 1
    return codes, codes_rc


encode_raw.launches = 0


def locate_window(cfg, idx, loc, lens, codes, codes_rc):
    """(found, gi, strand, off, loc_fwd, safe_loc, q, t) of each read's
    best diagonal `loc`: one launch of locate_window_kernel on CUDA
    tensors (two over a row-sharded text), the plain version on CPU
    tensors."""
    if loc.device.type == "cpu":
        return locate_window_plain(cfg, idx, loc, lens, codes, codes_rc)
    with torch.cuda.device(loc.device):
        return _locate_window_run(_lib(), _stream(loc.device), cfg, idx,
                                  loc, lens, codes, codes_rc)


def _locate_window_run(lib, stream, cfg, idx, loc, lens, codes, codes_rc):
    """locate_window through `lib`'s lrm_locate_window on `stream`."""
    B, L = cfg.B, cfg.L
    dev = loc.device
    pdt = idx.mta_start.dtype
    M = idx.mta_start.shape[0]
    _need("loc", loc, _POS, (B,))
    _need("lens", lens, I32, (B,))
    _need("codes", codes, torch.int8, (B, L))
    _need("codes_rc", codes_rc, torch.int8, (B, L))
    _need("mta_start", idx.mta_start, _POS, (M,))
    _need("mta_len", idx.mta_len, pdt, (M,))
    if L % 16:
        raise ValueError(f"locate_window: L {L} is not a multiple of 16")
    ins = dict(loc=loc.contiguous(), lens=lens.contiguous(),
               codes=codes.contiguous(), codes_rc=codes_rc.contiguous(),
               mta_start=idx.mta_start.contiguous(),
               mta_len=idx.mta_len.contiguous())
    _check("locate_window", dev, ins)
    out = dict(found=torch.empty(B, dtype=torch.bool, device=dev),
               gi=torch.empty(B, dtype=I32, device=dev),
               strand=torch.empty(B, dtype=torch.bool, device=dev),
               off=torch.empty(B, dtype=pdt, device=dev),
               loc_fwd=torch.empty(B, dtype=pdt, device=dev),
               safe_loc=torch.empty(B, dtype=pdt, device=dev),
               q=torch.empty((B, L), dtype=torch.int8, device=dev),
               t=torch.empty((B, L), dtype=torch.int8, device=dev))
    for k in ("codes", "codes_rc"):
        _aligned(k, ins[k])
    tp = idx.text_packed
    fields = dict(
        loc=ins["loc"].data_ptr(), lens=ins["lens"].data_ptr(),
        codes=ins["codes"].data_ptr(), codes_rc=ins["codes_rc"].data_ptr(),
        start=ins["mta_start"].data_ptr(), slen=ins["mta_len"].data_ptr(),
        **{k: t.data_ptr() for k, t in out.items()},
        B=B, L=L, M=M, n=cfg.n, ntext=tp.shape[0],
        p64=int(pdt == torch.int64), loc64=int(loc.dtype == torch.int64))
    if _sharded(idx, "text_packed"):
        # the locate and the word indices first, then the collective
        # gathers the words, then the window
        widx = torch.empty((B, L // 16 + 1), dtype=torch.int64, device=dev)
        _call(lib, "lrm_locate_window", LocateArgs(
            **fields, text=None, widx=widx.data_ptr(), stage=_STAGE_LOCATE),
            stream)
        locate_window.launches += 1
        words, stage = tp[widx].contiguous(), _STAGE_WINDOW
    else:
        words, stage = tp.contiguous(), _STAGE_ALL
    if words.dtype != I32:
        raise TypeError(f"text_packed must be int32, got {words.dtype}")
    _check("locate_window", dev, dict(text_packed=words))
    _call(lib, "lrm_locate_window", LocateArgs(
        **fields, text=words.data_ptr(), widx=None, stage=stage), stream)
    locate_window.launches += 1
    return tuple(out[k] for k in ("found", "gi", "strand", "off", "loc_fwd",
                                  "safe_loc", "q", "t"))


locate_window.launches = 0


def lanes(wcol, lens, limit, found, overflow, Wp: int, narrow: bool):
    """(ed_raw, band_short, overflow, lens_tb), each (B,), from the DP's
    (L+1, B) int16 centre column: one launch of lanes_kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if wcol.device.type == "cpu":
        return lanes_plain(wcol, lens, limit, found, overflow, Wp, narrow)
    with torch.cuda.device(wcol.device):
        return _lanes_run(_lib(), _stream(wcol.device), wcol, lens, limit,
                          found, overflow, Wp, narrow)


def _lanes_run(lib, stream, wcol, lens, limit, found, overflow, Wp: int,
               narrow: bool):
    """lanes through `lib`'s lrm_lanes on `stream`."""
    dev = wcol.device
    L1, B = wcol.shape
    _need("wcol", wcol, torch.int16, (L1, B))
    _need("lens", lens, I32, (B,))
    _need("limit", limit, I32, (B,))
    _need("found", found, torch.bool, (B,))
    _need("overflow", overflow, torch.bool, (B,))
    ins = dict(wcol=wcol.contiguous(), lens=lens.contiguous(),
               limit=limit.contiguous(), found=found.contiguous(),
               ovf_in=overflow.contiguous())
    _check("lanes", dev, ins)
    out = dict(ed_raw=torch.empty(B, dtype=I32, device=dev),
               band_short=torch.empty(B, dtype=torch.bool, device=dev),
               overflow=torch.empty(B, dtype=I32, device=dev),
               lens_tb=torch.empty(B, dtype=I32, device=dev))
    _call(lib, "lrm_lanes", LanesArgs(
        **{k: t.data_ptr() for k, t in ins.items()},
        **{k: t.data_ptr() for k, t in out.items()},
        B=B, L=L1 - 1, Wp=Wp, narrow=int(narrow)), stream)
    lanes.launches += 1
    return tuple(out[k] for k in ("ed_raw", "band_short", "overflow",
                                  "lens_tb"))


lanes.launches = 0


def pack(cfg, best, found, gi, strand, off, ed_raw, limit, band_short,
         overflow, run_units, saturated=None):
    """dict(blob (B, 4 * meta_words + head) int8, ops_tail (B, K - head)
    int8) of the step's per-read values and its (B, R) run entries: one
    launch of pack_kernel on CUDA tensors, the plain version on CPU
    tensors.  `saturated` is the gact walk's 0-dim bool flag (bit 1), None
    on the resident path."""
    if run_units.device.type == "cpu":
        return pack_plain(cfg, best, found, gi, strand, off, ed_raw, limit,
                          band_short, overflow, run_units, saturated)
    with torch.cuda.device(run_units.device):
        return _pack_run(_lib(), _stream(run_units.device), cfg, best,
                         found, gi, strand, off, ed_raw, limit, band_short,
                         overflow, run_units, saturated)


def _pack_run(lib, stream, cfg, best, found, gi, strand, off, ed_raw, limit,
              band_short, overflow, run_units, saturated):
    """pack through `lib`'s lrm_pack on `stream`."""
    dev = run_units.device
    B, R = run_units.shape
    eb = cfg.tb_entry_bytes
    _need("run_units", run_units, torch.int16 if eb == 2 else I32, (B, R))
    for name, t, dtype in (("best", best, _POS), ("off", off, _POS),
                           ("found", found, torch.bool), ("gi", gi, I32),
                           ("strand", strand, torch.bool),
                           ("ed_raw", ed_raw, I32), ("limit", limit, I32),
                           ("band_short", band_short, torch.bool),
                           ("overflow", overflow, I32)):
        _need(name, t, dtype, (B,))
    if saturated is not None:
        _need("saturated", saturated, torch.bool, ())
    ins = dict(best=best.contiguous(), found=found.contiguous(),
               gi=gi.contiguous(), strand=strand.contiguous(),
               off=off.contiguous(), ed_raw=ed_raw.contiguous(),
               limit=limit.contiguous(), band_short=band_short.contiguous(),
               overflow=overflow.contiguous(), saturated=saturated,
               runs=run_units.contiguous())
    _check("pack", dev, ins)
    K = eb * R
    head = pack_head(cfg, K)
    blob = torch.empty((B, 4 * cfg.meta_words + head), dtype=torch.int8,
                       device=dev)
    tail = torch.empty((B, K - head), dtype=torch.int8, device=dev)
    _call(lib, "lrm_pack", PackArgs(
        **{k: _ptr(t) for k, t in ins.items()},
        blob=blob.data_ptr(), tail=tail.data_ptr(), B=B, R=R, eb=eb,
        head=head, pos64=int(cfg.pos64),
        best64=int(best.dtype == torch.int64),
        off64=int(off.dtype == torch.int64)), stream)
    pack.launches += 1
    return dict(blob=blob, ops_tail=tail)


pack.launches = 0
