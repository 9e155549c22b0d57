"""Host time packing reads for the device (TorchMapper.phase_s["prepare"],
the `mapper.prepare` spans: each chunk's parts, plus phase_s
["retry_pack"], the `mapper.retry.pack` spans: each retry step's part)
over the chunks completed in the window, in ms.  None where the program
keeps no `retry_pack` key."""


def read(run):
    n = len(run["chunks"])
    prepare = run["counters"].get("phase.prepare")
    retry_pack = run["counters"].get("phase.retry_pack")
    if not n or prepare is None or retry_pack is None:
        return None
    return (prepare + retry_pack) / n * 1e3
