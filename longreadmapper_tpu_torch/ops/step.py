"""The mapping step's glue around the DP and the walks (port of the parts
of longreadmapper_tpu/mapping/pipeline.py::make_map_step that XLA fuses
into the jitted step; none is a pallas_call):

  encode_raw(raw, lens)          -> (codes, codes_rc): raw_step's encode,
                                    each row at its own read length
  locate_window(cfg, idx, loc, lens, codes, codes_rc)
                                 -> (found, gi, strand, off, loc_fwd,
                                     safe_loc, q, t): the contig of each
                                    read's best diagonal (_seq_lookup), the
                                    read on its strand and its target window
  lanes(wcol, lens, limit, found, overflow, Wp, narrow)
                                 -> Lanes: G3, each lane's (ed_raw,
                                    band_short, overflow, lens_tb), the
                                    walk's inputs
  pack(cfg, best, found, gi, strand, off, lanes, limit, run_units,
       saturated)
                                 -> dict(blob, ops_tail): the step's output
  gact_setup(lens, n_rows, entry_dtype)
                                 -> (st, buf): the gact walk's state and
                                    its run buffer of pads, int16 or int32
                                    entries

On a CUDA tensor each launches its hand-written kernel in csrc/step.cu
(encode_kernel, locate_window_kernel, pack_kernel, lanes_kernel), counted
in `<wrapper>.launches`, and raises on inputs the kernel does not take; on
a CPU tensor each runs its plain version (`<name>_plain`: the step's
PyTorch ops, whose `cuda_calls` count calls on the card, which the card's
map path leaves at 0).  G3 has no launch of its own on the card: `lanes`
checks its inputs and hands them on in a Lanes record, and the kernel
that needs a lane's walk length computes the lane's values from the
inputs (csrc/lanes.cuh::lane_out) and writes the three the pack reads
into the record's tensors: walk_c_kernel on the resident path
(ops/traceback.py), lanes_kernel, the gact walk's setup, on the gact path
(gact_setup, ops/gact.py); each such launch counts in `lanes.launches`
and marks the record written, and `pack` raises on a record that no launch
has written.
Over a row-sharded text (parallel/dist.py's ShardedRows) locate_window
launches twice: the locate and the window's word indices, then, after
the collective has gathered the words, the window.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Optional

import torch

from .. import native_build
from .seed_vote import _call, _check, _ptr, _sharded, _stream

I32 = torch.int32
_STAGE_ALL, _STAGE_LOCATE, _STAGE_WINDOW = 0, 1, 2


# ------------------------------------------------------ the plain versions

def encode_raw_plain(raw, lens):
    """(codes, codes_rc) of a (B, L) uint8 ASCII chunk whose row i holds a
    read lens[i] long ((B,) int32 on raw's device, clamped to [0, L]; pad
    bytes 0): a/c/g/t of either case -> 0-3, every other byte -> 4, as the
    host encode's table; the reverse complement front-aligned with pad 4.
    Each row is rolled by its own length through one gather, no sync."""
    if raw.device.type == "cuda":
        encode_raw_plain.cuda_calls += 1
    u = raw | 32                                   # fold ASCII case
    codes = torch.full_like(raw, 4, dtype=torch.int8)
    for c, ch in enumerate(b"acgt"):
        codes = torch.where(u == ch, c, codes)
    comp = torch.where(codes < 4, 3 - codes, codes)
    # codes_rc[i, j] = comp[i, (L0 - 1 - j) mod L]: the flipped row rolled
    # left by L - L0, the read front-aligned and the pads wrapped to the
    # tail
    L = raw.shape[1]
    L0 = lens.to(torch.int64).clamp(0, L)[:, None]
    src = (L0 - 1 - torch.arange(L, device=raw.device)) % max(L, 1)
    return codes, comp.gather(1, src)


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


class LanesIn(ctypes.Structure):
    """csrc/lanes.cuh::LanesIn: every field 8 bytes.  wcol None: lens are
    the walk's lengths as given (no lanes)."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("wcol", "lens", "limit", "found", "ovf_in", "ed_raw",
                 "band_short", "overflow")] + [
        (k, ctypes.c_int64) for k in ("B", "L", "Wp", "narrow")]


@dataclasses.dataclass
class Lanes:
    """G3 of a step as `lanes` hands it to the walk and the pack: the
    values of lanes_plain.  On the card lens_tb is None, `src` holds the
    inputs' and the three other values' addresses and sizes and `keep`
    the tensors behind them: ed_raw, band_short and overflow hold the
    lane's values once the walk's launch (walk_c, or the gact setup) that
    computes them has been issued, which sets `written`."""
    ed_raw: torch.Tensor
    band_short: torch.Tensor
    overflow: torch.Tensor
    lens_tb: Optional[torch.Tensor] = None
    src: Optional[LanesIn] = None
    keep: tuple = ()
    written: bool = True

    def __iter__(self):
        """The four values in lanes_plain's order."""
        return iter((self.ed_raw, self.band_short, self.overflow,
                     self.lens_tb))


def gact_setup_plain(lens, n_rows: int, entry_dtype=torch.int16):
    """Plain version of gact_setup: the walk state st (3B + 3) int32 (each
    lane's i, j from its walk length and done where that is <= 0, then the
    shared write pointer, saturated count and CTA ticket at 0) and the run
    buffer (B, 2 n_rows) of pads in `entry_dtype`, built by eager ops."""
    if isinstance(lens, Lanes):
        lens = lens.lens_tb
    if lens.device.type == "cuda":
        gact_setup_plain.cuda_calls += 1
    l32 = lens.to(I32)
    st = torch.cat([l32, l32, (l32 <= 0).to(I32),
                    torch.zeros(3, dtype=I32, device=lens.device)])
    buf = torch.full((lens.shape[0], 2 * n_rows), 3, dtype=entry_dtype,
                     device=lens.device)
    return st, buf


gact_setup_plain.cuda_calls = 0


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
    _fields_ = [(k, ctypes.c_void_p) for k in ("raw", "codes", "codes_rc",
                                               "lens")
                ] + [(k, ctypes.c_int64) for k in ("B", "L")]


class LocateArgs(ctypes.Structure):
    """csrc/step.cu::LocateArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in
                ("loc", "lens", "codes", "codes_rc", "start", "slen", "text",
                 "found", "gi", "strand", "off", "loc_fwd", "safe_loc",
                 "widx", "q", "t")] + [
        (k, ctypes.c_int64) for k in
        ("B", "L", "M", "n", "ntext", "p64", "loc64", "stage")]


class SetupArgs(ctypes.Structure):
    """csrc/step.cu::SetupArgs: every field 8 bytes."""
    _fields_ = [("lanes", LanesIn), ("st", ctypes.c_void_p),
                ("buf", ctypes.c_void_p), ("B", ctypes.c_int64),
                ("n_rows", ctypes.c_int64), ("eb", ctypes.c_int64)]


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
              "lrm_gact_setup": _ARGS, "lrm_pack": _ARGS}
_POS = (I32, torch.int64)
_BOOL, _I8, _I32 = (torch.bool,), (torch.int8,), (I32,)


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


_SAME_DEVICE = contextlib.nullcontext()


def _on(dev):
    """A context that makes `dev` current where it is not: a ctypes launch
    goes to the current device (mapdist: one card a rank)."""
    if dev.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(dev)


def encode_raw(raw, lens):
    """(codes, codes_rc), each (B, L) int8, of a (B, L) uint8 ASCII chunk
    whose row i holds a read lens[i] long ((B,) int32 on raw's device):
    one launch of encode_kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    dev = raw.device
    if dev.type == "cpu":
        return encode_raw_plain(raw, lens)
    with _on(dev):
        return _encode_run(_lib(), _stream(dev), raw, lens)


def _encode_run(lib, stream, raw, lens):
    """encode_raw through `lib`'s lrm_encode on `stream`: codes and
    codes_rc are the two halves of one allocation (new_empty)."""
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise TypeError(f"raw must be (B, L) uint8, got {raw.dtype} "
                        f"{tuple(raw.shape)}")
    B, L = raw.shape
    _need("lens", lens, _I32, (B,))
    _check("encode_raw", raw.device, dict(lens=lens))
    raw = raw.contiguous()
    # new_empty and two as_strided views take less host time than
    # torch.empty and unbind (scripts/torch_glue_host.py)
    buf = raw.new_empty((2 * B * L,), dtype=torch.int8)
    codes = buf.as_strided((B, L), (L, 1))
    codes_rc = buf.as_strided((B, L), (L, 1), B * L)
    _call(lib, "lrm_encode", EncodeArgs(
        raw=raw.data_ptr(), codes=codes.data_ptr(),
        codes_rc=codes_rc.data_ptr(), lens=lens.data_ptr(), B=B, L=L),
        stream)
    encode_raw.launches += 1
    return codes, codes_rc


encode_raw.launches = 0


def locate_window(cfg, idx, loc, lens, codes, codes_rc):
    """(found, gi, strand, off, loc_fwd, safe_loc, q, t) of each read's
    best diagonal `loc`: one launch of locate_window_kernel on CUDA
    tensors (two over a row-sharded text), the plain version on CPU
    tensors."""
    dev = loc.device
    if dev.type == "cpu":
        return locate_window_plain(cfg, idx, loc, lens, codes, codes_rc)
    with _on(dev):
        return _locate_window_run(_lib(), _stream(dev), cfg, idx, loc, lens,
                                  codes, codes_rc)


def _locate_outputs(loc, B: int, L: int, pdt):
    """locate_window's eight outputs as views of one allocation
    (new_empty): q and t first (16-aligned, L % 16 == 0), then found and
    strand, gi and the three positions, each at an offset of its size."""
    pb = pdt.itemsize
    o_gi = (2 * B * L + 2 * B + 7) & ~7
    o_pos = (o_gi + 4 * B + 7) & ~7
    buf = loc.new_empty((o_pos + 3 * pb * B,), dtype=torch.int8)
    flags, words = buf.view(torch.bool), buf.view(I32)
    pos = words if pb == 4 else buf.view(pdt)
    off, loc_fwd, safe_loc = (pos.as_strided((B,), (1,), o_pos // pb + k * B)
                              for k in range(3))
    return (flags.as_strided((B,), (1,), 2 * B * L),
            words.as_strided((B,), (1,), o_gi // 4),
            flags.as_strided((B,), (1,), 2 * B * L + B), off, loc_fwd,
            safe_loc, buf.as_strided((B, L), (L, 1)),
            buf.as_strided((B, L), (L, 1), B * L))


def _locate_window_run(lib, stream, cfg, idx, loc, lens, codes, codes_rc):
    """locate_window through `lib`'s lrm_locate_window on `stream`: each
    input checked once (dtype and shape, raising TypeError; device,
    raising ValueError), the outputs views of one allocation."""
    B, L = cfg.B, cfg.L
    dev = loc.device
    pdt = idx.mta_start.dtype
    M = idx.mta_start.shape[0]
    if L % 16:
        raise ValueError(f"locate_window: L {L} is not a multiple of 16")
    ins = [loc, lens, codes, codes_rc, idx.mta_start, idx.mta_len]
    checks = (("loc", _POS, (B,)), ("lens", _I32, (B,)),
              ("codes", _I8, (B, L)), ("codes_rc", _I8, (B, L)),
              ("mta_start", _POS, (M,)), ("mta_len", (pdt,), (M,)))
    for i, (name, dtypes, shape) in enumerate(checks):
        t = ins[i]
        if t.dtype not in dtypes or t.shape != shape:
            _need(name, t, dtypes, shape)
        if t.device != dev:
            _check("locate_window", dev, {name: t})
        ins[i] = t.contiguous()
    _aligned("codes", ins[2])
    _aligned("codes_rc", ins[3])
    out = _locate_outputs(loc, B, L, pdt)
    fields = dict(
        loc=ins[0].data_ptr(), lens=ins[1].data_ptr(),
        codes=ins[2].data_ptr(), codes_rc=ins[3].data_ptr(),
        start=ins[4].data_ptr(), slen=ins[5].data_ptr(),
        **{k: t.data_ptr() for k, t in zip(_LOCATE_OUT, out)},
        B=B, L=L, M=M, n=cfg.n, ntext=idx.text_packed.shape[0],
        p64=int(pdt == torch.int64), loc64=int(loc.dtype == torch.int64))
    tp = idx.text_packed
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
    if words.device != dev:
        _check("locate_window", dev, dict(text_packed=words))
    _call(lib, "lrm_locate_window", LocateArgs(
        **fields, text=words.data_ptr(), widx=None, stage=stage), stream)
    locate_window.launches += 1
    return out


locate_window.launches = 0
_LOCATE_OUT = ("found", "gi", "strand", "off", "loc_fwd", "safe_loc", "q",
               "t")


def lanes(wcol, lens, limit, found, overflow, Wp: int, narrow: bool):
    """G3 of a step from the DP's (L+1, B) int16 centre column, the reads'
    lens and limits, found and the seed vote's bool overflow, as a Lanes:
    on CPU tensors lanes_plain's four values; on CUDA tensors no launch,
    each input checked once (dtype and shape, raising TypeError; device,
    raising ValueError) and handed on to the walk's launch, which computes
    the lanes' values (walk_c on a resident pass, the gact setup)."""
    if wcol.device.type == "cpu":
        return Lanes(*lanes_plain(wcol, lens, limit, found, overflow, Wp,
                                  narrow))
    return _lanes_in(wcol, lens, limit, found, overflow, Wp, narrow)


def _lanes_in(wcol, lens, limit, found, overflow, Wp: int, narrow: bool):
    """lanes' card route on tensors of any one device: the Lanes of the
    checked inputs and of the three tensors the walk's launch writes."""
    dev = wcol.device
    if wcol.dtype != torch.int16 or wcol.dim() != 2:
        raise TypeError(f"wcol must be (L + 1, B) int16, got {wcol.dtype} "
                        f"{tuple(wcol.shape)}")
    ins = [wcol, lens, limit, found, overflow]
    shape = (wcol.shape[1],)
    for i, (name, dtypes) in enumerate(_LANES_IN):
        t = ins[i]
        if i and (t.dtype not in dtypes or t.shape != shape):
            _need(name, t, dtypes, shape)
        if t.device != dev:
            _check("lanes", dev, {name: t})
        ins[i] = t.contiguous()
    # ed_raw, overflow and band_short, views of one allocation
    B = shape[0]
    out = wcol.new_empty((2 * B + (B + 3) // 4,), dtype=I32)
    ed_raw = out.as_strided(shape, (1,))
    ovf = out.as_strided(shape, (1,), B)
    short = out.view(torch.bool).as_strided(shape, (1,), 8 * B)
    src = LanesIn(*[t.data_ptr() for t in ins], ed_raw.data_ptr(),
                  short.data_ptr(), ovf.data_ptr(), B, wcol.shape[0] - 1, Wp,
                  int(narrow))
    return Lanes(ed_raw, short, ovf, None, src, tuple(ins), written=False)


# the launches that compute G3 on the card: walk_c_kernel and lanes_kernel
# given a Lanes
lanes.launches = 0
_LANES_IN = (("wcol", (torch.int16,)), ("lens", _I32), ("limit", _I32),
             ("found", _BOOL), ("overflow", _BOOL))


def _lanes_src(ln: Lanes, B: int, dev, who: str) -> LanesIn:
    """The card's LanesIn of `ln` for a consumer of B lanes on `dev`."""
    if ln.src is None or ln.ed_raw.device != dev or ln.src.B != B:
        raise ValueError(f"{who}: lanes of {ln.ed_raw.shape[0]} reads on "
                         f"{ln.ed_raw.device}; needs {B} on {dev}")
    return ln.src


def gact_setup(lens, n_rows: int, entry_dtype=torch.int16):
    """(st (3B + 3) int32, buf (B, 2 n_rows) of pads in `entry_dtype`,
    int16 or int32): the gact walk's state and run buffer (ops/gact.py)
    from each lane's walk length, a (B,) tensor (0 or less: no walk) or G3
    as a Lanes, whose values for the pack it writes.  One launch of
    lanes_kernel on CUDA tensors (counted in lanes.launches given a
    Lanes), st and buf views of one allocation; the plain version on CPU
    tensors."""
    if entry_dtype not in (torch.int16, I32):
        raise TypeError(f"run entries are int16 or int32, not {entry_dtype}")
    dev = lens.ed_raw.device if isinstance(lens, Lanes) else lens.device
    if dev.type == "cpu":
        return gact_setup_plain(lens, n_rows, entry_dtype)
    with _on(dev):
        return _gact_setup_run(_lib(), _stream(dev), lens, n_rows,
                               entry_dtype)


def _gact_setup_run(lib, stream, lens, n_rows: int, entry_dtype=torch.int16):
    """gact_setup through `lib`'s lrm_gact_setup on `stream`."""
    given = not isinstance(lens, Lanes)
    if given:
        if lens.dim() != 1:
            raise ValueError(f"lens must be (B,), got {tuple(lens.shape)}")
        B, dev = lens.shape[0], lens.device
        lens = lens.to(I32).contiguous()
        src = LanesIn(lens=lens.data_ptr(), B=B)
    else:
        B, dev = lens.ed_raw.shape[0], lens.ed_raw.device
        src = _lanes_src(lens, B, dev, "gact_setup")
    eb = entry_dtype.itemsize
    per = eb // 2                              # words a pair
    o = -(-(3 * B + 3) // 4) * 4               # the buffer 16-aligned
    mem = torch.empty((o + B * n_rows * per,), dtype=I32, device=dev)
    st = mem.as_strided((3 * B + 3,), (1,))
    words = mem.as_strided((B, n_rows * per), (n_rows * per, 1), o)
    _call(lib, "lrm_gact_setup", SetupArgs(
        src, st.data_ptr(), words.data_ptr(), B, n_rows, eb), stream)
    if not given:
        lanes.launches += 1
        lens.written = True
    return st, words.view(entry_dtype)


def pack(cfg, best, found, gi, strand, off, lanes, limit, run_units,
         saturated=None):
    """dict(blob (B, 4 * meta_words + head) int8, ops_tail (B, K - head)
    int8) of the step's per-read values, G3's (a Lanes: its ed_raw,
    band_short and overflow; raises ValueError where no walk's launch has
    written them) and its (B, R) run entries: one launch of pack_kernel on
    CUDA tensors, the plain version on CPU tensors.  `saturated` is the
    gact walk's 0-dim bool flag (bit 1), None on the resident path."""
    if not lanes.written:
        raise ValueError("pack: no walk's launch has written the lanes' "
                         "values; run device_traceback_c or "
                         "gact_traceback_c on this Lanes first")
    ed_raw, band_short, overflow = (lanes.ed_raw, lanes.band_short,
                                    lanes.overflow)
    dev = run_units.device
    if dev.type == "cpu":
        return pack_plain(cfg, best, found, gi, strand, off, ed_raw, limit,
                          band_short, overflow, run_units, saturated)
    with _on(dev):
        return _pack_run(_lib(), _stream(dev), cfg, best, found, gi, strand,
                         off, ed_raw, limit, band_short, overflow, run_units,
                         saturated)


# the per-read inputs in PackArgs' order, with their dtypes
_PACK_IN = (("best", _POS), ("found", _BOOL), ("gi", _I32),
            ("strand", _BOOL), ("off", _POS), ("ed_raw", _I32),
            ("limit", _I32), ("band_short", _BOOL), ("overflow", _I32))


def _pack_run(lib, stream, cfg, best, found, gi, strand, off, ed_raw, limit,
              band_short, overflow, run_units, saturated):
    """pack through `lib`'s lrm_pack on `stream`: each input checked once
    (dtype and shape, raising TypeError; device, raising ValueError), the
    blob and the tail two row-major halves of one allocation
    (new_empty)."""
    dev = run_units.device
    B, R = run_units.shape
    eb = cfg.tb_entry_bytes
    _need("run_units", run_units, torch.int16 if eb == 2 else I32, (B, R))
    ins = [best, found, gi, strand, off, ed_raw, limit, band_short,
           overflow]
    shape = (B,)
    for i, (name, dtypes) in enumerate(_PACK_IN):
        t = ins[i]
        if t.dtype not in dtypes or t.shape != shape:
            _need(name, t, dtypes, shape)
        if t.device != dev:
            _check("pack", dev, {name: t})
        ins[i] = t.contiguous()
    if saturated is not None:
        _need("saturated", saturated, torch.bool, ())
        _check("pack", dev, dict(saturated=saturated))
    runs = run_units.contiguous()
    K = eb * R
    head = pack_head(cfg, K)
    pitch, tail_pitch = 4 * cfg.meta_words + head, K - head
    buf = runs.new_empty((B * (pitch + tail_pitch),), dtype=torch.int8)
    blob = buf.as_strided((B, pitch), (pitch, 1))
    tail = buf.as_strided((B, tail_pitch), (tail_pitch, 1), B * pitch)
    _call(lib, "lrm_pack", PackArgs(
        *[t.data_ptr() for t in ins],
        _ptr(saturated), runs.data_ptr(),
        blob.data_ptr(), tail.data_ptr(), B, R, eb, head, int(cfg.pos64),
        int(best.dtype == torch.int64), int(off.dtype == torch.int64)),
        stream)
    pack.launches += 1
    return dict(blob=blob, ops_tail=tail)


pack.launches = 0
