"""Reads the retry tiers re-mapped (TorchMapper.retried_reads) over the
reads of the chunks completed in the window, in %."""


def read(run):
    reads = sum(ch["reads"] for ch in run["chunks"])
    retried = run["counters"].get("retried_reads")
    if not reads or retried is None:
        return None
    return 100.0 * retried / reads
