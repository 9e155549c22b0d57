"""Column-consuming CIGAR walk over packed direction words (port of
longreadmapper_tpu/ops/traceback.py::device_traceback_c and
traceback_c_iters).

An M-run descends rows at a fixed band column d, so from cell (i, j) the
path stays in column d until the first non-M direction below row i — the
next indel.  The per-(b, d) group bitmap `nm` (bit g set iff word g holds a
non-M pair) finds that group without touching every word; one iteration
consumes a whole M-run plus one indel, so iterations = #indels + 2.

Emits (count << 2) | op entries (ops 0=M 1=I 2=D, pad 3) in reverse path
order.

`device_traceback_c` launches the hand-written CUDA kernel
csrc/walk.cu::walk_c_kernel (a warp a lane over its columns in shared
memory, the whole walk in one launch, every element of `runs` written by
it, no host sync; counted in `device_traceback_c.launches`) on a CUDA
tensor, and runs the plain version `device_traceback_c_plain` on a CPU
tensor.  Its lanes' lengths come as a tensor or, on the map path, as G3
of the step glue (ops/step.py::Lanes): then the kernel computes each
lane's values from the lanes' inputs (csrc/lanes.cuh), its length for the
walk and the three the pack reads into the Lanes' tensors, and the launch
also counts in `step.lanes.launches`.  The plain version is eager
PyTorch: torch has no unsigned 32-bit logical shifts, clz or popcount, so
words are widened to int64 and masked to 32 bits, and the highest set
bit is found by an exact binary search; it
reads the loop's `any(~done)` on the host every iteration (counted in
`device_traceback_c.host_syncs`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import native_build
from . import step
from .seed_vote import _stream

OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 3
_MASK32 = 0xFFFFFFFF

# the C entries of csrc/walk.cu (the gact walk's wrapper is ops/gact.py's)
_P, _I = ctypes.c_void_p, ctypes.c_int
WALK_FUNCS = {
    "lrm_walk_c_lanes": [_P, _P],
    "lrm_gact_walk": [_P] * 7 + [_I] * 8 + [_P],
}


class WalkCArgs(ctypes.Structure):
    """csrc/walk.cu::WalkCArgs: every field 8 bytes."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("vdirs", "nm", "runs")] + [
        ("lanes", step.LanesIn)] + [
        (k, ctypes.c_int64) for k in
        ("G", "B", "band", "W", "n_iter", "entry_bytes")]


def traceback_c_iters(L: int, W: int) -> int:
    """Iteration bound: one per indel (<= ed <= W for in-limit reads) plus
    the final M-run / row-0 D-run and slack.  Callers mask over-limit and
    unmapped lanes to lens 0."""
    return W + 6


def msb32(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of int64 values in [0, 2^32); -1 for 0
    (i.e. 31 - clz(x))."""
    r = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        m = hi > 0
        r = r + m.to(x.dtype) * s
        x = torch.where(m, hi, x)
    return torch.where(x > 0, r, -1)


def group_below(nmf, bmidx, g_cur):
    """Highest group strictly below g_cur whose `nm` bit is set at each
    lane's (b, d), -1 if none.  nmf: the nm words, each flattened (B *
    band,); bmidx = b * band + d."""
    g2 = torch.full_like(g_cur, -1)
    for w in range(len(nmf) - 1, -1, -1):
        bw = nmf[w][bmidx].to(torch.int64) & _MASK32
        lim = (g_cur - (w << 5)).clamp(0, 32)
        bwk = bw & ((1 << lim) - 1)
        g2 = torch.where((g2 < 0) & (bwk != 0), (w << 5) + msb32(bwk), g2)
    return g2


def check_run_counts(cmax: int, entry_dtype, what: str) -> None:
    """Raises ValueError where a walk's run counts, up to `cmax` (`what`
    names it), overflow (count << 2) | op in `entry_dtype`: a signed
    int16's count field holds counts to 8191, an int32's to 2^29 - 1;
    TypeError for any other dtype.  Both walks check with it."""
    if entry_dtype not in (torch.int16, torch.int32):
        raise TypeError(f"run entries are int16 or int32, not {entry_dtype}")
    top = (1 << (torch.iinfo(entry_dtype).bits - 3)) - 1
    if cmax > top:
        raise ValueError(f"run counts up to {what} = {cmax} overflow "
                         f"{entry_dtype} entries, whose counts stop at {top}")


def device_traceback_c(vdirs, lens, L: int, W: int, nm,
                       entry_dtype=torch.int16):
    """vdirs (G, B, band) int32 direction words, lens (B,) (0 = skip the
    lane) or G3 as a step.Lanes (its lens_tb), nm (ceil(G/32), B, band)
    int32 group bitmap.

    Returns runs (B, 2 * traceback_c_iters(L, W)) of `entry_dtype`: one
    launch of csrc/walk.cu::walk_c_kernel on CUDA tensors (raises for what
    it does not take), the plain version on CPU tensors."""
    dev = vdirs.device
    if dev.type == "cpu":
        if isinstance(lens, step.Lanes):
            lens = lens.lens_tb
        return device_traceback_c_plain(vdirs, lens, L, W, nm, entry_dtype)
    with step._on(dev):
        return _walk_c_run(native_build.load("walk", WALK_FUNCS),
                           _stream(dev), vdirs, lens, L, W, nm, entry_dtype)


def _walk_c_run(lib, stream, vdirs, lens, L: int, W: int, nm, entry_dtype):
    """device_traceback_c's card route through `lib`'s lrm_walk_c_lanes on
    `stream`."""
    given = not isinstance(lens, step.Lanes)
    dev = vdirs.device
    G, B, band = vdirs.shape
    # mrun <= L and the row-0 D-run < band - W
    check_run_counts(max(L, band - W), entry_dtype, "max(L, band - W)")
    if vdirs.dtype != torch.int32 or nm.dtype != torch.int32:
        raise TypeError(f"vdirs and nm must be int32, got {vdirs.dtype}, "
                        f"{nm.dtype}")
    lens_dev = lens.device if given else lens.ed_raw.device
    if nm.device != dev or lens_dev != dev:
        raise ValueError(f"vdirs on {dev}, nm on {nm.device}, lens on "
                         f"{lens_dev}: one CUDA device")
    if not given:
        src = step._lanes_src(lens, B, dev, "walk_c")
    elif lens.shape != (B,):
        raise ValueError(f"walk_c takes lens (B,) = ({B},), got "
                         f"{tuple(lens.shape)}")
    else:
        lens = lens.to(torch.int32).contiguous()
        src = step.LanesIn(lens=lens.data_ptr(), B=B)
    if (nm.shape != (-(-G // 32), B, band)
            or not (vdirs.is_contiguous() and nm.is_contiguous())):
        raise ValueError(f"walk_c takes contiguous vdirs (G, B, band), nm "
                         f"(ceil(G/32), B, band); got {tuple(vdirs.shape)}, "
                         f"{tuple(nm.shape)}")
    n_iter = traceback_c_iters(L, W)
    # the kernel writes each lane's whole row, pads included
    runs = vdirs.new_empty((B, 2 * n_iter), dtype=entry_dtype)
    err = lib.lrm_walk_c_lanes(ctypes.byref(WalkCArgs(
        vdirs.data_ptr(), nm.data_ptr(), runs.data_ptr(), src, G, B, band, W,
        n_iter, runs.element_size())), stream)
    if err != 0:
        raise RuntimeError(f"walk_c kernel launch failed: error {err}")
    device_traceback_c.launches += 1
    if not given:
        step.lanes.launches += 1
        lens.written = True
    return runs


device_traceback_c.launches = 0
device_traceback_c.host_syncs = 0     # the plain version's, on any device

def device_traceback_c_plain(vdirs, lens, L: int, W: int, nm,
                             entry_dtype=torch.int16):
    """Plain version of device_traceback_c.  The loop stops early once
    every lane is done: one host sync per iteration (the JAX while_loop's
    `any(~done)` condition)."""
    if vdirs.device.type == "cuda":
        device_traceback_c_plain.cuda_calls += 1
    G, B, band = vdirs.shape
    check_run_counts(max(L, band - W), entry_dtype, "max(L, band - W)")
    dev = vdirs.device
    i64 = torch.int64
    Vf = vdirs.reshape(-1)
    nmf = [nm[w].reshape(-1) for w in range(nm.shape[0])]
    bidx = torch.arange(B, dtype=i64, device=dev)
    n_iter = traceback_c_iters(L, W)

    def word_at(g, d):
        flat = ((g * B + bidx) * band + d).clamp(0, G * B * band - 1)
        return Vf[flat].to(i64) & _MASK32

    i = lens.to(i64)
    j = i.clone()
    done = i <= 0
    buf = torch.full((n_iter, B, 2), OP_PAD, dtype=entry_dtype, device=dev)
    it = 0
    while it < n_iter and bool((~done).any()):
        active = ~done
        d = (j - i + W).clamp(0, band - 1)
        ii = (i - 1).clamp(min=0)
        g_cur, r = ii >> 4, ii & 15
        # current group's word, pairs above row i masked off
        w_cur = word_at(g_cur, d)
        sh = 2 * (15 - r)
        wm_cur = ((w_cur << sh) & _MASK32) >> sh
        in_cur = wm_cur != 0
        # highest group strictly below g_cur with a non-M pair
        g2 = group_below(nmf, (bidx * band + d).clamp(0, B * band - 1),
                         g_cur)
        has_below = g2 >= 0
        any_nm = active & (i > 0) & (in_cur | has_below)
        gstar = torch.where(in_cur, g_cur, g2.clamp(min=0))
        w2 = word_at(gstar, d)
        wsel = torch.where(in_cur, wm_cur, w2)
        # 15 - (clz(wsel) >> 1): the lowest row of the word with a non-M
        pstar = 15 - ((31 - msb32(wsel)) >> 1)
        re = torch.where(any_nm, gstar * 16 + pstar + 1, 0)
        mrun = torch.where(active, i - re, 0)
        i2 = i - mrun
        j2 = j - mrun
        psh = 2 * pstar.clamp(min=0)
        op = (torch.where(in_cur, wm_cur, w2) >> psh) & 3
        take_e = any_nm                 # apply the indel (op is 1 or 2)
        i3 = torch.where(take_e & (op == 1), i2 - 1, i2)
        j3 = torch.where(take_e & (op == 2), j2 - 1, j2)
        # row 0 reached with target left: the synthetic all-D row
        drun = torch.where(active & ~any_nm & (i2 == 0), j2.clamp(min=0), 0)
        j4 = torch.where(drun > 0, 0, j3)
        done = done | ((i3 == 0) & (j4 == 0))
        e1 = torch.where(mrun > 0, (mrun << 2) | OP_M, OP_PAD)
        e2 = torch.where(take_e, 4 | op,
                         torch.where(drun > 0, (drun << 2) | OP_D, OP_PAD))
        buf[it, :, 0] = e1.to(entry_dtype)
        buf[it, :, 1] = e2.to(entry_dtype)
        i, j = i3, j4
        it += 1
    device_traceback_c.host_syncs += it + (1 if it < n_iter else 0)
    return buf.permute(1, 0, 2).reshape(B, -1)


device_traceback_c_plain.cuda_calls = 0
