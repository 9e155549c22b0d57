"""Device time of the first passes (TorchMapper.phase_s
["first_pass_device"]: CUDA events from each part's H2D copies to its
blob's D2H copy, read after the wait the stream makes for that copy) over
the chunks completed in the window, in ms."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.first_pass_device")
    if not n or s is None:
        return None
    return s / n * 1e3
