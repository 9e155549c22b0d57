"""Device idle time under the SAM assembly: the union of the traced
window's `mapper.assemble` host spans (spans of that name nested in one
another merge) intersected with the gaps between the device's operations,
over the chunks completed in the window, in ms.  None where the trace
holds none of the program's own assembly spans (`mapper.assemble.*`
inside TorchMapper's `mapper.assemble`, longreadmapper_tpu_torch/utils/
trace.py)."""

from benchmark import reduce


def overlap_s(xs, ys) -> float:
    """Seconds that two lists of sorted disjoint (start, end) intervals
    share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    tr = run.get("trace")
    n = len(run["chunks"])
    if tr is None or not n:
        return None
    if not any(h[0].startswith("mapper.assemble.") for h in tr["host"]):
        return None
    lo, hi = tr["window"]
    spans = reduce.merged([(a, b) for name, a, b, _ in tr["host"]
                           if name == "mapper.assemble"], lo, hi)
    idle = reduce.gaps([(a, b) for _, a, b in tr["device_ops"]], lo, hi)
    return overlap_s(spans, idle) / n * 1e3
