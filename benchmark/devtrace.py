"""The traced run's record: a torch.profiler trace (CPU and CUDA activity)
of the measured window, reduced to plain lists, the busy and idle time of
the device, and the breakdown the result line carries.

Spans the benchmark records itself, around the calls into the mapper's
layers (the program has none of its own yet), are named `mapper.<step>`;
the window's start is the zero-length span `bench.window_start`.  Trace
times are seconds from that start."""

from __future__ import annotations

import bisect
import re

from . import reduce

WINDOW_MARK = "bench.window_start"
# the mapper's methods the traced run wraps in spans: method -> span name
SPANS = {"_prepare_chunk": "mapper.prepare",
         "_dispatch_chunk": "mapper.dispatch",
         "_fetch_chunk": "mapper.fetch",
         "_retry_saturation": "mapper.retry_saturation",
         "_retry_overflow": "mapper.retry_overflow",
         "_postprocess_sam": "mapper.assemble"}


def wrap_spans(mapper) -> None:
    """Wrap the mapper's layer calls (SPANS) in profiler spans, on this
    instance only; a method the program no longer has gets none."""
    from torch.profiler import record_function

    def wrapped(fn, name):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    for attr, name in SPANS.items():
        if hasattr(mapper, attr):
            setattr(mapper, attr, wrapped(getattr(mapper, attr), name))


class Tracer:
    """start() at the window's start, stop() once it has closed."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.running = False

    def start(self) -> None:
        from torch.profiler import record_function
        self.prof.start()
        self.running = True
        with record_function(WINDOW_MARK):
            pass

    def stop(self) -> None:
        if self.running:
            self.prof.stop()
            self.running = False

    def record(self, seconds: float) -> dict:
        """{"window": (0, seconds), "kernels": [(name, start, end)],
        "device_ops": the kernels, copies and sets, "host": [(name, start,
        end, parent index)] sorted by start}: seconds from the window's
        start."""
        evs = list(self.prof.events())
        t0 = next(e.time_range.start for e in evs if e.name == WINDOW_MARK)
        kernels, device_ops, cpu = [], [], []
        for e in evs:
            a = (e.time_range.start - t0) / 1e6
            b = (e.time_range.end - t0) / 1e6
            if e.device_type.name == "CUDA":
                # the spans above show on the device's timeline too, as
                # annotations: no operation ran there for them
                if getattr(e, "is_user_annotation", False) or \
                        e.name.startswith(("mapper.", "bench.")):
                    continue
                device_ops.append((e.name, a, b))
                if not e.name.startswith(("Memcpy", "Memset")):
                    kernels.append((e.name, a, b))
            elif e.name != WINDOW_MARK:
                cpu.append((a, b, e))
        cpu.sort(key=lambda x: x[0])
        at = {id(e): i for i, (_, _, e) in enumerate(cpu)}
        host = [(e.name, a, b, at.get(id(e.cpu_parent), -1))
                for a, b, e in cpu]
        return {"window": (0.0, float(seconds)), "kernels": kernels,
                "device_ops": device_ops, "host": host}


def _doing(host: list, starts: list, a: float, b: float) -> str:
    """What the host was doing over (a, b): the innermost mapper span and
    the innermost other host op that hold its midpoint.  Host ops nest, so
    the innermost holder is the last op to start before the midpoint or
    one of its parents."""
    m = (a + b) / 2
    i = bisect.bisect_right(starts, m) - 1
    span = op = None
    while i >= 0 and host[i][2] < m:
        i = host[i][3]
    while i >= 0 and span is None:
        name = host[i][0]
        if name.startswith("mapper."):
            span = name
        elif op is None:
            op = name
        i = host[i][3]
    return f"{span or 'stream'}/{op or 'python'}"


def short_name(name: str) -> str:
    """A traced kernel's function name without its namespace, template
    and argument list (`band_dp_wide_kernel`); other names as they are."""
    bare = name[5:] if name.startswith("void ") else name
    bare = bare.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", bare, maxsplit=1)[0].strip()
    if head != bare and re.fullmatch(r"[A-Za-z_][\w:]*", head):
        return head.split("::")[-1]
    return name[:120]


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time in the window (by
    name), and the window's idle time by what the host was doing (summed
    over gaps, the count of gaps in the name)."""
    lo, hi = trace["window"]
    by_op = {}
    for name, a, b in trace["device_ops"]:
        d = max(0.0, min(b, hi) - max(a, lo))
        if d > 0:
            k = short_name(name)
            by_op[k] = by_op.get(k, 0.0) + d
    idle = {}
    ivs = [(a, b) for _, a, b in trace["device_ops"]]
    starts = [h[1] for h in trace["host"]]
    for a, b in reduce.gaps(ivs, lo, hi):
        k = _doing(trace["host"], starts, a, b)
        n, s = idle.get(k, (0, 0.0))
        idle[k] = (n + 1, s + (b - a))
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{k} ({n} gaps)", s] for k, (n, s) in gaps]}
