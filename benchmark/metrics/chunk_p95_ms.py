"""The 95th percentile, over every chunk completed in the window, of the
time from the stream's pull of the chunk to the yield of its SAM text
(its wait in the queue and any retry step included), in ms."""

from benchmark import reduce


def read(run):
    lat = [ch["latency_s"] for ch in run["chunks"]]
    return reduce.p95(lat) * 1e3 if lat else None
