"""Host time blocked in the retry steps' copies (TorchMapper.phase_s
["retry_wait"], the program's `mapper.retry.wait` spans: the wait for the
queue ahead of the step, the step and its D2H copies) over the chunks
completed in the window, in ms."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.retry_wait")
    if not n or s is None:
        return None
    return s / n * 1e3
