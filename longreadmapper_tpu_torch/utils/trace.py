"""Host spans of the mapper's stream, on the clock of a torch.profiler
trace.

`Span(name, chunk, phase_s, key)` is a context manager that does two
things around a block of host code:

- with `key` given, it adds the block's host seconds (time.perf_counter)
  to `phase_s[key]`, always;
- only while a torch profiler records, it opens
  `torch.profiler.record_function(name, str(chunk))` around the block.
  Kineto puts such a span and the device's activity on one timeline, so
  any trace taken around the mapper shows its spans beside the kernels.

With no profiler running a span costs one flag check and, where it keeps
a phase_s key, two clock reads: no record_function is created.
"""

from __future__ import annotations

import time

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


class Span:
    __slots__ = ("name", "chunk", "phase", "key", "t0", "rf")

    def __init__(self, name: str, chunk=None, phase=None, key=None):
        self.name, self.chunk, self.phase, self.key = name, chunk, phase, key

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = record_function(
                self.name, None if self.chunk is None else str(self.chunk))
            self.rf.__enter__()
        if self.key is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.key is not None:
            self.phase[self.key] += time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False
