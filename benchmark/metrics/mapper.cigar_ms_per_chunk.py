"""Host time of the SAM assembly's CIGAR strings (TorchMapper.phase_s
["cigar"], the program's `mapper.assemble.cigar` spans) over the chunks
completed in the window, in ms; None where the program keeps no such
key."""


def read(run):
    n = len(run["chunks"])
    s = run["counters"].get("phase.cigar")
    if not n or s is None:
        return None
    return s / n * 1e3
