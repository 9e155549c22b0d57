"""The mapper's spans and phase seconds (longreadmapper_tpu_torch/utils/
trace.py) on the CPU, on a stream whose reads inside a 40x tandem repeat
overflow the compact vote and take the exact retry tier: under a
torch.profiler every span of the stream is there, nested as the stream
calls, each carrying its chunk's ordinal; with no profiler no
record_function is made; phase_s["retry"] holds the retry tier's time and
phase_s["fetch"] none of it."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import sample_reads
from _torch_parity import HLEN
from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.utils import trace
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)

# the span's nearest enclosing mapper span; None: a span of its own.  The
# overflow retry's issue (mapper.retry_overflow) and its finish a loop
# turn later (mapper.retry.finish, holding the wait) are spans apart; the
# wide vote class steps are issued inside mapper.retry.wide.
PARENTS = {"mapper.prepare": {None}, "mapper.dispatch": {None},
           "mapper.fetch": {None}, "mapper.retry_overflow": {None},
           "mapper.retry.finish": {None}, "mapper.assemble": {None},
           "mapper.h2d": {"mapper.dispatch", "mapper.retry_overflow",
                          "mapper.retry.wide"},
           "mapper.step": {"mapper.dispatch", "mapper.retry_overflow",
                           "mapper.retry.wide"},
           "mapper.d2h": {"mapper.dispatch", "mapper.retry_overflow",
                          "mapper.retry.wide"},
           "mapper.retry.pack": {"mapper.retry_overflow",
                                 "mapper.retry.wide"},
           "mapper.retry.wide": {"mapper.retry_overflow"},
           "mapper.retry.wait": {"mapper.retry.finish"},
           "mapper.assemble.cigar": {"mapper.assemble"},
           "mapper.assemble.records": {"mapper.assemble"}}


@pytest.fixture(scope="module")
def rep(tmp_path_factory):
    """tests/test_torch_e2e.py's repeat genome, indexed by the port, and
    its reads in four chunks (the depth-3 queue fills and drains)."""
    rng = np.random.default_rng(5)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    genome = rand(6000) + rand(60) * 40 + rand(6000)
    fa = str(tmp_path_factory.mktemp("spans") / "rep.fa")
    with open(fa, "w") as f:
        f.write(">rep\n" + genome + "\n")
    build_index(fa, Params(hlen=HLEN), verbose=False, device=None)
    idx, meta, mta = load_device_index(fa, "cpu", verbose=False)
    reads = [(n, s, "I" * len(s)) for n, s, *_ in sample_reads(
        rng, genome[5000:9400], 16, 200, error_rate=0.02)]
    chunks = [reads[s:s + 4] for s in range(0, len(reads), 4)]
    return dict(idx=idx, meta=meta, mta=mta, chunks=chunks)


def _map(rep):
    tm = TorchMapper(rep["idx"], rep["meta"], rep["mta"], Params(hlen=HLEN),
                     chunk_b=4, device="cpu")
    text = [t for t, _, _ in tm.map_stream_sam(iter(rep["chunks"]))]
    assert tm.retried_reads > 0
    return tm, text


def _spy(monkeypatch):
    """Record (name, args) of every record_function the mapper makes."""
    made = []
    real = trace.record_function

    def spy(name, args=None):
        made.append((name, args))
        return real(name, args)

    monkeypatch.setattr(trace, "record_function", spy)
    return made


def _mapper_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("mapper."):
        p = p.cpu_parent
    return p


def test_stream_spans_nest_and_carry_their_chunk(rep, monkeypatch):
    _, plain = _map(rep)
    made = _spy(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tm, text = _map(rep)
    assert text == plain
    evs = sorted((e for e in prof.events() if e.name.startswith("mapper.")),
                 key=lambda e: e.time_range.start)
    assert {e.name for e in evs} == set(PARENTS)
    assert len(evs) == len(made)
    # the profiler keeps no args here: pair each event with the call that
    # made it, the i-th span of a name with the i-th call of that name
    # (spans of one name never nest)
    args, seen = {}, {}
    calls = {}
    for name, a in made:
        calls.setdefault(name, []).append(a)
    for e in evs:
        i = seen.get(e.name, 0)
        seen[e.name] = i + 1
        args[id(e)] = calls[e.name][i]
    for e in evs:
        parent = _mapper_parent(e)
        assert (parent and parent.name) in PARENTS[e.name], e.name
        if parent is not None:
            assert args[id(e)] == args[id(parent)], e.name
    # both places that stage, issue and copy back a step do so in their
    # own spans
    for name in ("mapper.h2d", "mapper.step", "mapper.d2h"):
        assert {_mapper_parent(e).name for e in evs if e.name == name} == \
            PARENTS[name]
    n = len(rep["chunks"])
    for name in ("mapper.prepare", "mapper.dispatch", "mapper.fetch",
                 "mapper.assemble"):
        assert calls[name] == [str(k) for k in range(n)], name
    assert set(calls["mapper.retry_overflow"]) <= {str(k) for k in range(n)}
    assert tm.submitted_chunks == n


def test_no_record_function_without_a_profiler(rep, monkeypatch):
    made = _spy(monkeypatch)
    for mod in (torch.profiler, torch.autograd.profiler):
        real = mod.record_function

        def counted(*a, real=real):
            made.append(a)
            return real(*a)

        monkeypatch.setattr(mod, "record_function", counted)
    tm, _ = _map(rep)
    assert made == []
    assert tm.phase_s["prepare"] > 0 and tm.phase_s["assemble"] > 0


def test_retry_time_is_in_retry_not_in_fetch(rep, monkeypatch):
    delay, steps = 0.25, []
    for name in ("_issue_step", "_finish_step"):
        real = getattr(TorchMapper, name)

        def slow(self, *a, real=real, **k):
            steps.append(1)
            time.sleep(delay)
            return real(self, *a, **k)

        monkeypatch.setattr(TorchMapper, name, slow)
    tm, _ = _map(rep)
    ph = tm.phase_s
    assert steps and ph["retry"] >= delay * len(steps)
    assert ph["fetch"] < delay
    assert ph["retry"] >= ph["retry_wait"] > 0
    # the retry steps' packing (mapper.retry.pack) is another part of it
    assert ph["retry"] >= ph["retry_wait"] + ph["retry_pack"]
    assert ph["retry_pack"] > 0
    # no device: the CUDA events' keys stay 0
    assert ph["first_pass_device"] == ph["retry_device"] == 0.0


def test_pack_ms_per_chunk_reads_prepare_and_retry_pack(rep):
    """benchmark/metrics/mapper.pack_ms_per_chunk.py over the stream's
    own counters: the first passes' and the retry steps' packing a chunk,
    and nothing where the program keeps no retry_pack key."""
    from benchmark.run import reader, snapshot
    tm, _ = _map(rep)
    counters = snapshot(tm)
    run = dict(counters=counters, chunks=[{}] * len(rep["chunks"]))
    read = reader("mapper.pack_ms_per_chunk")
    ph = tm.phase_s
    assert read(run) == pytest.approx(
        (ph["prepare"] + ph["retry_pack"]) / len(rep["chunks"]) * 1e3)
    assert read(run) > 0
    del counters["phase.retry_pack"]
    assert read(run) is None
    assert read(dict(run, chunks=[])) is None


class _Clock:
    """A stand-in for a timing CUDA event on the CPU: the host clock at
    its record, elapsed_time in ms as torch.cuda.Event gives it."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3

    def synchronize(self):
        pass


def test_wide_vote_device_is_a_part_of_retry_device(rep, monkeypatch):
    """The class steps' device time (phase_s wide_vote_device) is taken
    as the retry steps' (retry_device) is, and is a part of it; the class
    steps' issue (wide_vote) is a part of retry."""
    monkeypatch.setattr(TorchMapper, "_event", lambda self: _Clock())
    wide, every = [], []
    real = TorchMapper._finish_step

    def finish(self, step, chunk=None):
        dt = step.start.elapsed_time(step.end) / 1e3
        every.append(dt)
        if step.wide:
            wide.append(dt)
        return real(self, step, chunk)

    monkeypatch.setattr(TorchMapper, "_finish_step", finish)
    tm, _ = _map(rep)
    ph = tm.phase_s
    assert len(wide) == tm.wide_vote_steps > 0
    assert len(every) == tm.retry_steps > len(wide)
    assert ph["wide_vote_device"] == pytest.approx(sum(wide))
    assert ph["retry_device"] == pytest.approx(sum(every))
    assert 0 < ph["wide_vote_device"] < ph["retry_device"]
    assert 0 < ph["wide_vote"] < ph["retry"]
    assert tm.wide_vote_unresolved == tm.overflow_reads == 0
