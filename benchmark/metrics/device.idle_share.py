"""The share of the traced window in which no operation (kernel, copy or
set, named in benchmark/kernel_layers.json or not) ran on the device, in
%."""

from benchmark import reduce


def read(run):
    tr = run.get("trace")
    if tr is None or not tr["device_ops"]:
        return None
    lo, hi = tr["window"]
    busy = reduce.busy_s([(a, b) for _, a, b in tr["device_ops"]], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
