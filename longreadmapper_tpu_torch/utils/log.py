"""mlog-equivalent logger: timestamped verbose/error channels on stderr (the
port's copy of longreadmapper_tpu/utils/log.py: `Logger`, `new_logger`).

The reference's mlog contract: `vlog` returns a perf-counter timestamp for
phase-timing chains (reference alnmain.c:279-309), `elapse(t)` gives the
seconds since `t` (mutils.c:45-50 `time_elapse`).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class Logger:
    stream: object = field(default_factory=lambda: sys.stderr)
    verbose: bool = True

    def _stamp(self) -> str:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())

    def vlog(self, fmt: str, *args) -> float:
        """Verbose log. Returns a timestamp for timing chains (mlog.mvlog)."""
        if self.verbose:
            msg = fmt % args if args else fmt
            print(f"[{self._stamp()}] {msg}", file=self.stream, flush=True)
        return time.perf_counter()

    def elog(self, fmt: str, *args) -> float:
        """Error log (mlog.melog)."""
        msg = fmt % args if args else fmt
        print(f"[{self._stamp()}] ERROR: {msg}", file=self.stream, flush=True)
        return time.perf_counter()

    @staticmethod
    def elapse(t0: float) -> float:
        """Seconds since `t0` (reference: mutils.c:45-50 time_elapse)."""
        return time.perf_counter() - t0


def new_logger(stream=None, verbose: bool = True) -> Logger:
    """Reference: `new_mlogger(NULL)` (alnmain.c:279)."""
    return Logger(stream=stream or sys.stderr, verbose=verbose)
