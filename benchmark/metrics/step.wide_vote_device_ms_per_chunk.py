"""Device time of the exact retry tier's wide vote class steps
(TorchMapper.phase_s["wide_vote_device"]: CUDA events from each class
step's H2D copies to its last kernel, read after the step's deferred
wait; a part of phase_s["retry_device"]) over the chunks completed in
the window, in ms.  None where the program keeps no such key."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.wide_vote_device")
    if not n or s is None:
        return None
    return s / n * 1e3
