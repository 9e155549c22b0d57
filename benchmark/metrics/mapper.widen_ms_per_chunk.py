"""Host time widening run entries from int16 to int32 in the overflow
retry's splice (TorchMapper.phase_s["widen"], the program's
`mapper.retry.widen` spans: the first pass's rows where the retry's
entries are wider, the retry's where the first pass's are) over the chunks
completed in the window, in ms.  None where the program keeps no such
key."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.widen")
    if not n or s is None:
        return None
    return s / n * 1e3
