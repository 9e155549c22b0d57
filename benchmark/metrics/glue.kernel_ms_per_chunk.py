"""Device time of the window's kernels that benchmark/kernel_layers.json
puts in the layer step glue, over the chunks completed in the window, in
ms."""

from benchmark import reduce


def read(run):
    tr = run.get("trace")
    if tr is None or not run["chunks"]:
        return None
    s = reduce.layer_s(tr, run["layers"], "step glue")
    return None if s is None else s / len(run["chunks"]) * 1e3
