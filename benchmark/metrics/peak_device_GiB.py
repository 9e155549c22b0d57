"""torch.cuda.max_memory_allocated since the index was on the card (the
index, the warm-up and the window), in GiB."""


def read(run):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
