"""The stream's overflow retry in two stages on the CPU (TorchMapper.
_fetch_chunk issues a chunk's retry steps, _finish_chunk waits for them a
loop turn later): on tests/test_torch_spans.py's repeat genome, chunks of
1.1 kb reads whose bucket (2048, B 8 at chunk_b 16) splits each into two
parts, four chunks over the 40x tandem repeat that retry and one of
unique reads that retries nothing.  The stream yields what map_chunk
gives chunk by chunk; chunk c-1's steps are issued before chunk c-2 is
assembled, every part's before any waits, and no wait comes before the
next chunk's dispatch; every retry of a stream is deferred, none of
map_chunk's; the stream drains in order."""

import numpy as np
import pytest
import torch

from conftest import sample_reads
from _torch_parity import HLEN
from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)

UNIQUE = 2        # the chunk of unique reads: no part retries


@pytest.fixture(scope="module")
def rep(tmp_path_factory):
    """The repeat genome indexed by the port, five chunks of 12 reads
    (two parts each), and map_chunk's SAM and records of each chunk."""
    rng = np.random.default_rng(5)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    genome = rand(6000) + rand(60) * 40 + rand(6000)
    fa = str(tmp_path_factory.mktemp("stream_retry") / "rep.fa")
    with open(fa, "w") as f:
        f.write(">rep\n" + genome + "\n")
    build_index(fa, Params(hlen=HLEN), verbose=False, device=None)
    idx, meta, mta = load_device_index(fa, "cpu", verbose=False)

    def reads(region, n, tag):
        return [(tag + name, s, "I" * len(s)) for name, s, *_ in
                sample_reads(rng, region, n, 1100, error_rate=0.02)]

    over = reads(genome[4500:9900], 48, "r")
    chunks = [over[s:s + 12] for s in range(0, 48, 12)]
    chunks.insert(UNIQUE, reads(genome[9000:], 12, "u"))
    rep = dict(idx=idx, meta=meta, mta=mta, chunks=chunks)
    tm = _mapper(rep)
    rep["records"] = [tm.map_chunk(c) for c in chunks]
    rep["map_chunk"] = tm
    return rep


def _mapper(rep):
    return TorchMapper(rep["idx"], rep["meta"], rep["mta"], Params(hlen=HLEN),
                       chunk_b=16, device="cpu")


def _spy(monkeypatch):
    """(stage, chunk ordinal) of every stage and step the mapper runs, in
    order: dispatch, fetch (the issue stage), issue (a retry step), finish
    (the finish stage), wait (a retry step's), assemble."""
    seen = []

    def spy(name, method, chunk_of):
        real = getattr(TorchMapper, method)

        def call(self, *a, **k):
            seen.append((name, chunk_of(a, k)))
            return real(self, *a, **k)

        monkeypatch.setattr(TorchMapper, method, call)

    spy("dispatch", "_dispatch_chunk", lambda a, k: a[1])
    spy("fetch", "_fetch_chunk", lambda a, k: a[0][0][3]["chunk"])
    spy("issue", "_issue_step", lambda a, k: a[2])
    spy("finish", "_finish_chunk", lambda a, k: a[0][0][3]["chunk"])
    spy("wait", "_finish_step", lambda a, k: a[2])
    spy("assemble", "_assemble_sam", lambda a, k: a[0][0][3]["chunk"])
    spy("assemble", "_assemble", lambda a, k: a[0][0][3]["chunk"])
    return seen


def _spied_stream(rep):
    """map_stream_sam over rep's chunks under the spy: (mapper, its
    yields, the spy's log)."""
    with pytest.MonkeyPatch.context() as mp:
        seen = _spy(mp)
        tm = _mapper(rep)
        out = list(tm.map_stream_sam(iter(rep["chunks"])))
    return tm, out, seen


@pytest.fixture(scope="module")
def stream(rep):
    """The whole stream of rep's five chunks, spied."""
    return _spied_stream(rep)


def _stage_order(n):
    """The chunk stages of a stream of n chunks, in the order the stream
    must run them: a loop turn dispatches c, issues c-1, finishes and
    assembles c-2; the drain issues the last chunk, then finishes and
    assembles the rest in order."""
    want = []
    for c in range(n):
        want.append(("dispatch", c))
        if c >= 1:
            want.append(("fetch", c - 1))
        if c >= 2:
            want += [("finish", c - 2), ("assemble", c - 2)]
    want.append(("fetch", n - 1))
    for c in range(max(0, n - 2), n):
        want += [("finish", c), ("assemble", c)]
    return want


def _sam(records):
    return ["".join(r.to_sam() for r in c) for c in records]


@pytest.mark.parametrize("kind", ["map_stream_sam", "map_stream"])
def test_stream_yields_what_map_chunk_gives(rep, stream, kind):
    if kind == "map_stream":
        tm = _mapper(rep)
        assert list(tm.map_stream(iter(rep["chunks"]))) == rep["records"]
    else:
        tm, got, _ = stream
        assert [t for t, _, _ in got] == _sam(rep["records"])
        assert [n for _, n, _ in got] == [len(c) for c in rep["chunks"]]
    ref = rep["map_chunk"]
    assert (tm.retried_reads, tm.retry_steps, tm.overflow_reads) == (
        ref.retried_reads, ref.retry_steps, ref.overflow_reads)


def test_stream_issues_ahead_and_waits_behind_the_next_dispatch(
        rep, stream):
    tm, _, seen = stream
    n = len(rep["chunks"])
    at = {}
    for i, e in enumerate(seen):
        at.setdefault(e, []).append(i)
    # every chunk but the unique one issues a step for each of its parts
    assert [len(at.get(("issue", k), [])) for k in range(n)] == \
        [0 if k == UNIQUE else 2 for k in range(n)]
    assert [len(at.get(("wait", k), [])) for k in range(n)] == \
        [0 if k == UNIQUE else 2 for k in range(n)]
    for k in range(n):
        if k == UNIQUE:
            continue
        # all of a chunk's steps are queued before any of them is waited
        assert max(at[("issue", k)]) < min(at[("wait", k)])
        # chunk k's steps are issued before chunk k-1 is assembled
        if k >= 1:
            assert max(at[("issue", k)]) < at[("assemble", k - 1)][0]
        # the next chunk's first pass, and in the loop the one after it,
        # are queued before chunk k's wait
        for j in (k + 1, k + 2):
            if j < n:
                assert at[("dispatch", j)][0] < min(at[("wait", k)])
    assert tm.retry_steps == 8 and tm.retried_reads > 0


def test_every_stream_retry_is_deferred(rep, stream):
    tm = stream[0]
    assert tm.deferred_retry_steps == tm.retry_steps > 0
    # map_chunk issues and finishes a chunk at once: nothing deferred
    ref = rep["map_chunk"]
    assert ref.retry_steps == tm.retry_steps
    assert ref.deferred_retry_steps == 0


@pytest.mark.parametrize("n", [1, 2, 5])
def test_stream_drains_in_order(rep, stream, n):
    if n == len(rep["chunks"]):
        _, out, seen = stream
    else:
        _, out, seen = _spied_stream(dict(rep, chunks=rep["chunks"][:n]))
    assert [e for e in seen if e[0] not in ("issue", "wait")] == \
        _stage_order(n)
    assert [t for t, _, _ in out] == _sam(rep["records"][:n])
