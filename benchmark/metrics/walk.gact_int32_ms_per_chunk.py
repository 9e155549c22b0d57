"""Device time of the gact walk's int32 instantiation
(csrc/walk.cu::gact_walk_kernel<int32_t>: the walks whose run counts can
pass int16's 8191, the full-band retry of reads past ~80 kb) in the
window, over the chunks completed in it, in ms.  None where the trace
holds no launch of it (a program whose gact walk has one entry width)."""

import re

INT32_WALK = re.compile(r"(?<![A-Za-z0-9_])gact_walk_kernel<int>")


def read(run):
    tr = run.get("trace")
    if tr is None or not run["chunks"]:
        return None
    lo, hi = tr["window"]
    total, seen = 0.0, False
    for name, a, b in tr["kernels"]:
        if INT32_WALK.search(name):
            seen = True
            total += max(0.0, min(b, hi) - max(a, lo))
    return total / len(run["chunks"]) * 1e3 if seen else None
