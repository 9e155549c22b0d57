"""Host time issuing the exact retry tier's wide vote class steps
(TorchMapper.phase_s["wide_vote"], the program's `mapper.retry.wide`
spans: packing each class's reads, staging and issuing its steps and
queueing their copies) over the chunks completed in the window, in ms.
None where the program keeps no such key."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.wide_vote")
    if not n or s is None:
        return None
    return s / n * 1e3
