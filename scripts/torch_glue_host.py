#!/usr/bin/env python3
"""Where the host time of the step glue's encode and pack wrappers goes,
on one NVIDIA GPU, at the 1 kb bucket's shapes (encode: B 2048, L 1024;
pack: B 2048, R 216 int16 run entries, the full int32 layout), inputs
made with numpy from --seed (tests/_glue_inputs.py).

For each wrapper (ops/step.py's encode_raw and pack): its host time a
call (perf_counter over --calls calls, the device synchronised once at
the end) and its CUDA-event median (as chip_smoke.py phase 3c times it);
then, one by one, the host time a call of the steps that the first
design's wrappers took and of those that replace them: the
torch.cuda.device context, the current stream as a Stream object and as
a raw handle, torch.cuda.current_device, torch.empty on the card (and
ways to make two outputs of one allocation), each check on a tensor,
the first pack's checks (_need, .contiguous() and _check of its ten
tensors: saturated is None on the resident path), a ctypes Structure of
the argument block built by keywords against struct.pack, and the C
entry alone (the kernel's launch) on a prebuilt block.

  python3 scripts/torch_glue_host.py [--calls N] [--seed N]

The JSON printed last holds every number (us a call) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
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
    v = G.to_torch(G.pack_case(rng, B, R, 2, False), dev)
    cfg = G.cfg(B, L, 1000)
    pargs = (cfg, v["best"], v["found"], v["gi"], v["strand"], v["off"],
             v["ed_raw"], v["limit"], v["band_short"], v["overflow"],
             v["runs"], None)
    lib = S._lib()
    n = args.calls
    out = dict(card=card, calls=n)

    def whole(name, fn):
        out[name] = dict(host_us=host_us(fn, n),
                         event_us=event_us(fn, min(n, 200)))
        print(f"[glue host] {name}: {json.dumps(out[name])}", flush=True)

    whole("encode_raw", lambda: S.encode_raw(raw, L0))
    whole("pack", lambda: S.pack(*pargs))

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

    class PackArgs(ctypes.Structure):
        """The argument block as a ctypes Structure: csrc/step.cu::PackArgs."""
        _fields_ = [(k, ctypes.c_void_p) for k in
                    ("best", "found", "gi", "strand", "off", "ed_raw",
                     "limit", "band_short", "overflow", "saturated",
                     "runs", "blob", "tail")] + [
            (k, ctypes.c_int64) for k in
            ("B", "R", "eb", "head", "pos64", "best64", "off64")]

    ptrs = {k: t.data_ptr() for k, t in named.items()}
    blob = torch.empty((B, 48), dtype=torch.int8, device=dev)
    tail = torch.empty((B, 2 * R - 16), dtype=torch.int8, device=dev)
    fields = dict(ptrs, saturated=None, blob=blob.data_ptr(),
                  tail=tail.data_ptr(), B=B, R=R, eb=2, head=16, pos64=0,
                  best64=0, off64=0)
    block = S._PACK_ARGS.pack(*[fields[k] or 0 for k, _ in
                                PackArgs._fields_])
    stream = S._stream(dev)
    ctx = torch.cuda.device(dev)

    def enter_exit():
        ctx.__enter__()
        ctx.__exit__(None, None, None)

    parts = {
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
        "ctypes PackArgs(**fields)": lambda: PackArgs(**fields),
        "struct.pack of the block": lambda: S._PACK_ARGS.pack(
            *[fields[k] or 0 for k, _ in PackArgs._fields_]),
        "lrm_pack alone (the launch)": lambda: lib.lrm_pack(block, stream),
    }
    out["parts"] = {}
    for name, fn in parts.items():
        out["parts"][name] = host_us(fn, n)
        print(f"[glue host] {name}: {out['parts'][name]:.3f} us",
              flush=True)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
