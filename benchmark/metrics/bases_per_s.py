"""Read bases of the chunks whose SAM text the stream returned inside the
window, over the window's seconds, in Mbase/s."""


def read(run):
    if not run["chunks"]:
        return None
    return sum(ch["bases"] for ch in run["chunks"]) / run["window_s"] / 1e6
