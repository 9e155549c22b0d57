"""Suffix-array builds: the port of longreadmapper_tpu/index/sa.py.

`sa_build` writes `<prefix>.sa5` in the 40-bit codec, by the in-RAM SA-IS
(the port's copy `csrc/sais.cpp`, built with g++ at first use into
`_build/libsais.so` by native_build.py and called through ctypes) or, when
a RAM budget is given and the in-RAM build would pass it, by the blocked
external-memory build (index/sa_external.py).  A failed build raises with
g++'s message; there is no slower fallback.  `sa_build_device` is the
card-side prefix-doubling build (JAX `sa_build_xla`); `sa_load` reads a
`.sa5` whole."""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import native_build
from ..device import pick_device
from ..formats.ui40 import read_sa5, write_sa5

_FUNCS = {"lrm_sais_u8": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]}


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array (int64) of a uint8 text, suffixes compared with an
    implicit terminal sentinel smaller than every byte (the convention of
    longreadmapper_tpu.native.suffix_array)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    lib = native_build.load("sais", _FUNCS)
    # n + 1 slots: the build's sentinel scratch, so it needs no copy
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.lrm_sais_u8(text.ctypes.data, n, sa.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"lrm_sais_u8 failed: {rc}")
    return sa[:n]


def sa_build(prefix: str, ram_use: int = 0, log=None) -> np.ndarray:
    """Build and persist `<prefix>.sa5`; returns the SA as int64.

    `ram_use` (bytes, the reference's `sa_build` ram parameter) bounds the
    construction's working set: when the in-RAM SA-IS footprint (~12
    B/char) would pass it, the blocked external-memory build runs instead,
    byte-identical.  0 = in-RAM.  `log` (a Logger.vlog) hears the external
    build's block count."""
    n = os.path.getsize(prefix)
    if ram_use > 0 and n * 12 > ram_use:
        from .sa_external import sa_build_external
        blocks = sa_build_external(prefix, ram_use)
        if log is not None:
            log("sa_build: external build, %d blocks within %d bytes",
                blocks, ram_use)
        return read_sa5(prefix + ".sa5")
    text = np.fromfile(prefix, dtype=np.uint8)
    sa = suffix_array(text)
    write_sa5(sa, prefix + ".sa5")
    return sa


def sa_load(prefix: str) -> np.ndarray:
    """Load `<prefix>.sa5` whole (the reference's alnmain.c:242-252)."""
    return read_sa5(prefix + ".sa5")


def sa_build_device(codes: np.ndarray,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Suffix array by prefix doubling on a torch device: the counterpart
    of JAX `longreadmapper_tpu/index/sa.py::sa_build_xla`, equal to it and
    to `suffix_array` element for element.

    codes: (n,) uint8, 0..3 = ACGT and 4 = '$' (the one terminator, last),
    as index/fmi.py::encode_bytes gives for a .cat.  Each round sorts the
    positions by (rank, rank of the suffix k further on), as one int64 key
    ((rank + 1) << 32 | (rank2 + 0x7FFFFFFF): both fields stay non-negative
    below 2^31 positions), numbers the runs of equal keys in sorted order
    (the new ranks), and scatters the ranks back to position order.  A suffix
    past the end ranks -0x7FFFFFFF (JAX's dynamic slice clamps there, also
    in a round with k >= n), '$' ranks -1.  Ties inside a round are
    unordered but share their new rank, so the result is determined.  One
    host sync a round, for the exit once every rank is distinct.  Returns
    the int64 SA on the host; `sa_build_device.rounds` keeps the last
    call's round count."""
    n = int(codes.shape[0])
    if n >= 2**31:      # the key's 32-bit rank fields, and JAX's bound
        raise ValueError(f"sa_build_device takes n < 2^31 codes, got {n}")
    dev = pick_device(device)
    c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev)
    rank = torch.where(c == 4, -1, c.to(torch.int64))
    del c
    k, rounds = 1, 0
    while True:
        key = (rank + 1) << 32
        if k < n:
            key[:n - k] += rank[k:] + 0x7FFFFFFF
        skey, sa = torch.sort(key)
        del key
        new = torch.zeros(n, dtype=torch.int64, device=dev)
        new[1:] = (skey[1:] != skey[:-1]).cumsum(0)
        del skey
        rank[sa] = new
        rounds += 1
        maxr = int(new[-1])
        del new
        if maxr == n - 1 or k >= n:
            break
        k *= 2
    sa_build_device.rounds = rounds
    return sa.cpu().numpy()


sa_build_device.rounds = 0
