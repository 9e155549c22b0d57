"""Device time of the retry tiers' steps (TorchMapper.phase_s
["retry_device"]: CUDA events from each retry step's H2D copies to its
last kernel, read after the step's blocking copies) over the chunks
completed in the window, in ms."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.retry_device")
    if not n or s is None:
        return None
    return s / n * 1e3
