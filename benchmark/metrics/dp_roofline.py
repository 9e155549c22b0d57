"""The DP kernels' share of their roofline: the least time of the DP work
the window's completed chunks needed (benchmark/reduce.py::dp_bound_s:
the reads' real lengths at each tier's band, cells x 12 int32 ops at 16.7
Tops/s or bytes at 3.35 TB/s, the larger) over the traced time, up to the
last completed chunk's yield, of the kernels benchmark/kernel_layers.json
puts in the layer DP, in %."""

from benchmark import reduce


def read(run):
    tr = run.get("trace")
    if tr is None or not run["chunks"]:
        return None
    until = max(ch["end_s"] for ch in run["chunks"])
    s = reduce.layer_s(tr, run["layers"], "DP", until)
    bound = reduce.dp_bound_s(run["chunks"])
    if not s or bound is None:
        return None
    return 100.0 * bound / s
