"""The share of the traced window's gact steps whose run entries are int32
(TorchMapper's int32_gact_steps over gact_steps), in %: each gact step
launches csrc/step.cu::lanes_kernel<EB>, the gact walk's setup, once, its
instantiation naming the step's entry bytes, so the share is the
lanes_kernel<4> launches over every lanes_kernel<EB> launch.  None where
the trace holds no launch that names its width (a program whose setup
kernel takes none)."""

import re

SETUP = re.compile(r"(?<![A-Za-z0-9_])lanes_kernel<(\d+)>")


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    lo, hi = tr["window"]
    n = n32 = 0
    for name, a, _ in tr["kernels"]:
        m = SETUP.search(name)
        if m and lo <= a < hi:
            n += 1
            n32 += m.group(1) == "4"
    return 100.0 * n32 / n if n else None
