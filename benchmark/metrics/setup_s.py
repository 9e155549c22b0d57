"""Seconds from the process's start to the window's: imports, CUDA
initialisation, the kernel build check, the genome, the index, the read
pool and the warm-up."""


def read(run):
    return run["setup_s"]
