"""The mapper's host time a chunk over the window: prepare + dispatch +
assemble of TorchMapper.phase_s (fetch, the wait for the device, left
out), over the chunks completed in the window, in ms."""


def read(run):
    n = len(run["chunks"])
    if not n:
        return None
    parts = [run["counters"].get("phase." + k)
             for k in ("prepare", "dispatch", "assemble")]
    if None in parts:
        return None
    return sum(parts) / n * 1e3
