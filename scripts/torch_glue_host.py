#!/usr/bin/env python3
"""Where the host time of the step glue's wrappers and the walks' launch
paths goes, on one NVIDIA GPU, at the 1 kb bucket's shapes (encode: B
2048, L 1024; pack: B 2048, R 216 int16 run entries, the full int32
layout; locate_window: B 2048, L 1024 on a 4 Mb text of one contig;
lanes and walk_c: B 2048, L 1024, band 256, on zero direction words, so
each lane's walk is one iteration) and at the 50 kb bucket's for the gact
walk's setup (B 40, 5228 buffer rows), inputs made with numpy from --seed
(tests/_glue_inputs.py).

For each wrapper (ops/step.py's encode_raw, pack, locate_window, lanes
and gact_setup, ops/traceback.py's device_traceback_c on a
Lanes and on given lengths): its host time a call (perf_counter over
--calls calls, the device synchronised once at the end) and its
CUDA-event median (as chip_smoke.py phase 3c times it); then, one by
one, the host time a call of the steps that the earlier designs'
wrappers took and of those that replace them: the torch.cuda.device
context, the current stream as a Stream object and as a raw handle,
torch.cuda.current_device, torch.empty on the card (and ways to make two
outputs of one allocation; locate_window's eight outputs as eight
torch.empty and as views of one new_empty), each check on a tensor, the
first pack's checks (_need, .contiguous() and _check of its ten
tensors: saturated is None on the resident path) and locate_window's
(six tensors), the lanes launch's (its five inputs checked three times,
four outputs) against a Lanes' (each input once), the gact walk's setup
as eager ops (the fill and the state's concatenation) against its
launch, a ctypes Structure of the argument block built by keywords
against struct.pack, and the C entries alone (the kernels' launches) on
prebuilt blocks: lrm_pack, lrm_locate_window, lrm_walk_c_lanes,
lrm_gact_setup.  Last, locate_window whole with its eight outputs made
two ways, paired: --rounds rounds, each timing both ways (--calls calls
each, the order turned every round), as views of one new_empty
(_locate_outputs, the wrapper's) and as eight torch.empty.

  python3 scripts/torch_glue_host.py [--calls N] [--rounds N] [--seed N]

The JSON printed last holds every number (us a call) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import struct
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, calls: int) -> float:
    """Host us a call of fn over `calls` calls after a warm-up call; the
    device synchronised before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def event_us(fn, calls: int) -> float:
    """CUDA-event median us of fn, each call timed alone."""
    import torch
    fn()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import numpy as np
    import torch
    import _glue_inputs as G
    from longreadmapper_tpu_torch.ops import step as S
    from longreadmapper_tpu_torch.ops.seed_vote import _check
    if not torch.cuda.is_available():
        raise SystemExit("torch_glue_host.py needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    B, L, L0, R = 2048, 1024, 1000, 216
    raw = torch.from_numpy(G.raw_case(rng, B, L, L0)).to(dev)
    rlens = torch.full((B,), L0, dtype=torch.int32, device=dev)
    v = G.to_torch(G.pack_case(rng, B, R, 2, False), dev)
    cfg = G.cfg(B, L, 1000)
    pargs = (cfg, v["best"], v["found"], v["gi"], v["strand"], v["off"],
             S.Lanes(v["ed_raw"], v["band_short"], v["overflow"]),
             v["limit"], v["runs"], None)
    lib = S._lib()
    n = args.calls
    out = dict(card=card, calls=n)

    def whole(name, fn):
        out[name] = dict(host_us=host_us(fn, n),
                         event_us=event_us(fn, min(n, 200)))
        print(f"[glue host] {name}: {json.dumps(out[name])}", flush=True)

    whole("encode_raw", lambda: S.encode_raw(raw, rlens))
    whole("pack", lambda: S.pack(*pargs))

    # locate_window on a 4 Mb text of one contig
    from types import SimpleNamespace
    from longreadmapper_tpu_torch.ops import traceback as TB
    from longreadmapper_tpu_torch.ops.gact import gact_runs_cols_c
    ntext = 1 << 22
    _, packed = G.text(rng, ntext)
    idx = SimpleNamespace(
        mta_start=torch.zeros(1, dtype=torch.int32, device=dev),
        mta_len=torch.full((1,), (ntext - 1) // 2, dtype=torch.int32,
                           device=dev),
        text_packed=torch.from_numpy(packed).to(dev))
    lcfg = G.cfg(B, L, ntext)
    loc = torch.from_numpy(rng.integers(0, ntext - 2 * L, B).astype(
        np.int32)).to(dev)
    qlen = torch.full((B,), L0, dtype=torch.int32, device=dev)
    codes, codes_rc = S.encode_raw(raw, rlens)
    largs = (lcfg, idx, loc, qlen, codes, codes_rc)
    whole("locate_window", lambda: S.locate_window(*largs))

    # G3: the Lanes against the earlier lanes launch's checks and outputs,
    # then the launches that compute it: walk_c on zero words (one
    # iteration a lane), the gact walk's setup
    W, band = 102, 256
    lw = [torch.from_numpy(x).to(dev) for x in G.lanes_case(rng, B, L)]
    lw[0].clamp_(0, 50)
    lw[2].fill_(100)
    lane_args = (*lw, W, False)
    whole("lanes (no launch)", lambda: S.lanes(*lane_args))
    ln = S.lanes(*lane_args)
    vdirs = torch.zeros((L // 16, B, band), dtype=torch.int32, device=dev)
    nm = torch.zeros((L // 512, B, band), dtype=torch.int32, device=dev)
    lens_tb = S.lanes_plain(*lane_args)[3]
    whole("device_traceback_c on the Lanes",
          lambda: TB.device_traceback_c(vdirs, ln, L, W, nm))
    whole("device_traceback_c on given lengths",
          lambda: TB.device_traceback_c(vdirs, lens_tb, L, W, nm))
    Bg, Lg, Tg, Wg = 40, 50176, 512, 2508
    n_rows = gact_runs_cols_c(Lg, Tg, Wg) // 2
    lg = [torch.from_numpy(x).to(dev) for x in G.lanes_case(rng, Bg, Lg)]
    lng = S.lanes(*lg, Wg, True)
    lens_g = S.lanes_plain(*lg, Wg, True)[3]
    whole("gact_setup on the Lanes (one launch)",
          lambda: S.gact_setup(lng, n_rows))
    whole("the gact walk's eager setup (fill, concatenation)",
          lambda: S.gact_setup_plain(lens_g, n_rows))

    # the first pack wrapper's checks: _need (dtype and shape),
    # .contiguous() and _check (device and contiguity) of its ten tensors
    named = dict(best=v["best"], found=v["found"], gi=v["gi"],
                 strand=v["strand"], off=v["off"], ed_raw=v["ed_raw"],
                 limit=v["limit"], band_short=v["band_short"],
                 overflow=v["overflow"], runs=v["runs"])
    dtypes = dict(best=S._POS, off=S._POS, found=torch.bool,
                  strand=torch.bool, band_short=torch.bool,
                  runs=torch.int16)

    def first_checks():
        for k, t in named.items():
            S._need(k, t, dtypes.get(k, torch.int32),
                    (B, R) if k == "runs" else (B,))
        ins = {k: t.contiguous() for k, t in named.items()}
        _check("pack", dev, ins)

    # the argument block (csrc/step.cu::PackArgs, every field 8 bytes) as
    # a ctypes Structure and by struct
    names = [k for k, _ in S.PackArgs._fields_]
    ptrs = {k: t.data_ptr() for k, t in named.items()}
    blob = torch.empty((B, 48), dtype=torch.int8, device=dev)
    tail = torch.empty((B, 2 * R - 16), dtype=torch.int8, device=dev)
    fields = dict(ptrs, saturated=None, blob=blob.data_ptr(),
                  tail=tail.data_ptr(), B=B, R=R, eb=2, head=16, pos64=0,
                  best64=0, off64=0)
    pack_block = struct.Struct(f"<{len(names)}q")
    block = pack_block.pack(*[fields[k] or 0 for k in names])
    stream = S._stream(dev)
    ctx = torch.cuda.device(dev)

    def enter_exit():
        ctx.__enter__()
        ctx.__exit__(None, None, None)

    # locate_window's earlier checks (_need, .contiguous(), _check of its
    # six tensors) and outputs (eight torch.empty)
    lnamed = dict(loc=loc, lens=qlen, codes=codes, codes_rc=codes_rc,
                  mta_start=idx.mta_start, mta_len=idx.mta_len)
    lshape = dict(codes=(B, L), codes_rc=(B, L), mta_start=(1,),
                  mta_len=(1,))

    def locate_checks():
        for k, t in lnamed.items():
            S._need(k, t, torch.int8 if k.startswith("codes")
                    else torch.int32, lshape.get(k, (B,)))
        ins = {k: t.contiguous() for k, t in lnamed.items()}
        _check("locate_window", dev, ins)

    def locate_empties():
        return ([torch.empty(B, dtype=d, device=dev) for d in (
            torch.bool, torch.int32, torch.bool, torch.int32, torch.int32,
            torch.int32)] + [torch.empty((B, L), dtype=torch.int8,
                                         device=dev) for _ in range(2)])

    # the earlier lanes launch: its five inputs through _need, .contiguous()
    # and _check, and its four outputs
    lanes_named = dict(wcol=lw[0], lens=lw[1], limit=lw[2], found=lw[3],
                       ovf_in=lw[4])

    def lanes_launch_checks():
        for k, t in lanes_named.items():
            S._need(k, t, t.dtype, t.shape)
        ins = {k: t.contiguous() for k, t in lanes_named.items()}
        _check("lanes", dev, ins)
        return [torch.empty(B, dtype=d, device=dev) for d in (
            torch.int32, torch.bool, torch.int32, torch.int32)]

    out_views = S._locate_outputs(loc, B, L, torch.int32)
    lfields = dict(
        loc=loc.data_ptr(), lens=qlen.data_ptr(), codes=codes.data_ptr(),
        codes_rc=codes_rc.data_ptr(), start=idx.mta_start.data_ptr(),
        slen=idx.mta_len.data_ptr(),
        **{k: t.data_ptr() for k, t in zip(S._LOCATE_OUT, out_views)},
        text=idx.text_packed.data_ptr(), widx=None, B=B, L=L, M=1, n=ntext,
        ntext=idx.text_packed.shape[0], p64=0, loc64=0, stage=0)
    lblock = S.LocateArgs(**lfields)
    wlib = TB.native_build.load("walk", TB.WALK_FUNCS)
    n_iter = TB.traceback_c_iters(L, W)
    runs = torch.empty((B, 2 * n_iter), dtype=torch.int16, device=dev)
    wblock = TB.WalkCArgs(vdirs.data_ptr(), nm.data_ptr(), runs.data_ptr(),
                          ln.src, L // 16, B, band, W, n_iter, 2)
    st_g, buf_g = S.gact_setup(lng, n_rows)
    sblock = S.SetupArgs(lng.src, st_g.data_ptr(), buf_g.data_ptr(), Bg,
                         n_rows, 2)

    parts = {
        "locate_window: the earlier checks (6 tensors, 3 checks each)":
            locate_checks,
        "locate_window: 8 torch.empty outputs": locate_empties,
        "locate_window: one new_empty and its views (_locate_outputs)":
            lambda: S._locate_outputs(loc, B, L, torch.int32),
        "LocateArgs(**fields)": lambda: S.LocateArgs(**lfields),
        "lrm_locate_window alone (the launch)":
            lambda: lib.lrm_locate_window(ctypes.byref(lblock), stream),
        "lanes: the earlier launch's checks and 4 torch.empty":
            lanes_launch_checks,
        "lanes: the Lanes (checks once, LanesIn)":
            lambda: S.lanes(*lane_args),
        "WalkCArgs(...)": lambda: TB.WalkCArgs(
            vdirs.data_ptr(), nm.data_ptr(), runs.data_ptr(), ln.src,
            L // 16, B, band, W, n_iter, 2),
        "lrm_walk_c_lanes alone (a block, the launch)":
            lambda: wlib.lrm_walk_c_lanes(ctypes.byref(wblock), stream),
        "lrm_gact_setup alone (the launch)":
            lambda: lib.lrm_gact_setup(ctypes.byref(sblock), stream),
        "torch.cuda.device enter+exit": enter_exit,
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream handle (_stream)": lambda: S._stream(dev),
        "torch.cuda.current_device": torch.cuda.current_device,
        "torch.empty (2048, 1024) int8": lambda: torch.empty(
            (B, L), dtype=torch.int8, device=dev),
        "torch.empty (2, 2048, 1024) int8 + unbind": lambda: torch.empty(
            (2, B, L), dtype=torch.int8, device=dev).unbind(0),
        "torch.empty (2, 2048, 1024) int8 + [0], [1]": lambda: (
            lambda t: (t[0], t[1]))(torch.empty((2, B, L), dtype=torch.int8,
                                                device=dev)),
        "raw.new_empty (2, 2048, 1024)": lambda: raw.new_empty(
            (2, B, L), dtype=torch.int8),
        "torch.empty of the pack's blob and tail + 2 as_strided":
            lambda: (lambda t: (t.as_strided((B, 48), (48, 1)),
                                t.as_strided((B, 416), (416, 1), B * 48)))(
                torch.empty(B * 464, dtype=torch.int8, device=dev)),
        "t.device != dev": lambda: v["gi"].device != dev,
        "t.get_device() != 0": lambda: v["gi"].get_device() != 0,
        "t.dtype in (int32,)": lambda: v["gi"].dtype in S._I32,
        "t.shape != (B,)": lambda: v["gi"].shape != (B,),
        "t.contiguous()": lambda: v["gi"].contiguous(),
        "t.is_contiguous()": lambda: v["gi"].is_contiguous(),
        "t.data_ptr()": lambda: v["gi"].data_ptr(),
        "the first pack's checks (10 tensors)": first_checks,
        "ctypes PackArgs(**fields)": lambda: S.PackArgs(**fields),
        "struct.pack of the block": lambda: pack_block.pack(
            *[fields[k] or 0 for k in names]),
        "lrm_pack alone (the launch)": lambda: lib.lrm_pack(block, stream),
    }
    out["parts"] = {}
    for name, fn in parts.items():
        out["parts"][name] = host_us(fn, n)
        print(f"[glue host] {name}: {out['parts'][name]:.3f} us",
              flush=True)

    # locate_window whole, its outputs as views of one new_empty against
    # eight torch.empty, paired round by round in turned order
    views = S._locate_outputs

    def empties(loc_, B_, L_, pdt):
        e = [torch.empty(B_, dtype=d, device=loc_.device) for d in (
            torch.bool, torch.int32, torch.bool, pdt, pdt, pdt)]
        return (*e, *(torch.empty((B_, L_), dtype=torch.int8,
                                  device=loc_.device) for _ in range(2)))

    want = [x.clone() for x in S.locate_window(*largs)]
    paired = {"views": [], "empties": []}
    try:
        for r in range(args.rounds):
            order = ("views", "empties") if r % 2 == 0 else ("empties",
                                                            "views")
            for way in order:
                S._locate_outputs = views if way == "views" else empties
                got = S.locate_window(*largs)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"locate_window ({way}) differs")
                paired[way].append(host_us(lambda: S.locate_window(*largs),
                                           n))
    finally:
        S._locate_outputs = views
    diffs = [e - w for w, e in zip(paired["views"], paired["empties"])]
    out["locate_window outputs, paired"] = dict(
        rounds=args.rounds, calls=n,
        views_median_us=statistics.median(paired["views"]),
        empties_median_us=statistics.median(paired["empties"]),
        empties_minus_views_median_us=statistics.median(diffs),
        rounds_views_faster=sum(d > 0 for d in diffs),
        views_us=paired["views"], empties_us=paired["empties"])
    print(f"[glue host] locate_window outputs, paired: "
          f"{json.dumps(out['locate_window outputs, paired'])}", flush=True)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
