"""The stream's overflow retry in two stages on the CPU (TorchMapper.
_fetch_chunk issues a chunk's retry steps, _finish_chunk waits for them a
loop turn later): on tests/test_torch_spans.py's repeat genome, chunks of
1.1 kb reads whose bucket (2048, B 8 at chunk_b 16) splits each into two
parts, four chunks over the 40x tandem repeat that retry and one of
unique reads that retries nothing.  The stream yields what map_chunk
gives chunk by chunk; chunk c-1's steps are issued before chunk c-2 is
assembled, every part's before any waits, and no wait comes before the
next chunk's dispatch; a part issues one exact-tier step and, for the
reads whose vote passes its slots, one wide vote class step, and with
the classes off one exact-tier step (the same reads in all); every retry
of a stream is deferred, none of map_chunk's; the stream drains in
order."""

import numpy as np
import pytest
import torch

from conftest import sample_reads
from _torch_parity import HLEN
from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.models import mapper as tmapper
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
    order: dispatch, fetch (the issue stage), issue (an exact-tier retry
    step) or issue.wide (a wide vote class step), finish (the finish
    stage), wait or wait.wide (a retry step's), assemble.  Returns that
    log and (tag, chunk, read names) of every retry step issued."""
    seen, issued = [], []

    def spy(name, method, chunk_of):
        real = getattr(TorchMapper, method)

        def call(self, *a, **k):
            tag = name
            if name in ("issue", "wait"):
                cfg = a[0] if name == "issue" else a[0].cfg
                if any(cfg is c for c in self._wide_cfgs.values()):
                    tag = name + ".wide"
            seen.append((tag, chunk_of(a, k)))
            if name == "issue":
                issued.append((tag, chunk_of(a, k),
                               tuple(r[0] for r in a[1])))
            return real(self, *a, **k)

        monkeypatch.setattr(TorchMapper, method, call)

    spy("dispatch", "_dispatch_chunk", lambda a, k: a[1])
    spy("fetch", "_fetch_chunk", lambda a, k: a[0][0].chunk)
    spy("issue", "_issue_step", lambda a, k: a[2])
    spy("finish", "_finish_chunk", lambda a, k: a[0][0].chunk)
    spy("wait", "_finish_step", lambda a, k: a[1])
    spy("assemble", "_assemble", lambda a, k: a[0][0].chunk)
    return seen, issued


def _spied_stream(rep, classes=True):
    """map_stream_sam over rep's chunks under the spy: (mapper, its
    yields, the spy's log, the retry steps issued).  With `classes`
    False every flagged read takes the exact tier (no wide vote class
    step)."""
    with pytest.MonkeyPatch.context() as mp:
        seen, issued = _spy(mp)
        if not classes:
            mp.setattr(tmapper, "vote_classes",
                       lambda need, slots: np.zeros(len(need), np.int64))
        tm = _mapper(rep)
        out = list(tm.map_stream_sam(iter(rep["chunks"])))
    return tm, out, seen, issued


@pytest.fixture(scope="module")
def stream(rep):
    """The whole stream of rep's five chunks, spied."""
    return _spied_stream(rep)


@pytest.fixture(scope="module")
def stream_exact(rep):
    """The same stream with the wide vote classes off."""
    return _spied_stream(rep, classes=False)


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
        tm, got, _, _ = stream
        assert [t for t, _, _ in got] == _sam(rep["records"])
        assert [n for _, n, _ in got] == [len(c) for c in rep["chunks"]]
    ref = rep["map_chunk"]
    assert (tm.retried_reads, tm.retry_steps, tm.overflow_reads) == (
        ref.retried_reads, ref.retry_steps, ref.overflow_reads)


def _at(seen):
    at = {}
    for i, e in enumerate(seen):
        at.setdefault(e, []).append(i)
    return at


def _counts(at, tag, n):
    return [len(at.get((tag, k), [])) for k in range(n)]


def _assert_issued_ahead(rep, at):
    n = len(rep["chunks"])
    for k in range(n):
        if k == UNIQUE:
            continue
        steps = at.get(("issue", k), []) + at.get(("issue.wide", k), [])
        waits = at.get(("wait", k), []) + at.get(("wait.wide", k), [])
        # all of a chunk's steps are queued before any of them is waited
        assert max(steps) < min(waits)
        # chunk k's steps are issued before chunk k-1 is assembled
        if k >= 1:
            assert max(steps) < at[("assemble", k - 1)][0]
        # the next chunk's first pass, and in the loop the one after it,
        # are queued before chunk k's wait
        for j in (k + 1, k + 2):
            if j < n:
                assert at[("dispatch", j)][0] < min(waits)


def test_stream_issues_ahead_and_waits_behind_the_next_dispatch(
        rep, stream, stream_exact):
    tm, _, seen, issued = stream
    n = len(rep["chunks"])
    at = _at(seen)
    exact, wide = _counts(at, "issue", n), _counts(at, "issue.wide", n)
    assert _counts(at, "wait", n) == exact
    assert _counts(at, "wait.wide", n) == wide
    # a part issues at most one exact-tier step and one wide vote class
    # step, and each flagged read in exactly one of them: the reads the
    # exact tier alone retries (stream_exact), chunk by chunk
    assert exact[UNIQUE] == wide[UNIQUE] == 0
    assert max(exact) <= 2 and max(wide) <= 2
    assert [min(e + w, 2) for e, w in zip(exact, wide)] == \
        [0 if k == UNIQUE else 2 for k in range(n)]
    for k in range(n):
        got = [r for _, c, rs in issued if c == k for r in rs]
        want = [r for _, c, rs in stream_exact[3] if c == k for r in rs]
        assert sorted(got) == sorted(want)
        assert len(set(got)) == len(got)
    assert tm.retried_reads == stream_exact[0].retried_reads
    assert sum(wide) == tm.wide_vote_steps > 0
    assert tm.retry_steps - tm.wide_vote_steps == sum(exact)
    assert tm.retried_reads > tm.wide_vote_reads > 0
    _assert_issued_ahead(rep, at)


def test_exact_tier_alone_issues_a_step_a_part(rep, stream_exact):
    """With the wide vote classes off, every chunk but the unique one
    issues one exact-tier step for each of its parts, and waits for it."""
    tm, _, seen, _ = stream_exact
    n = len(rep["chunks"])
    at = _at(seen)
    for tag in ("issue", "wait"):
        assert _counts(at, tag, n) == \
            [0 if k == UNIQUE else 2 for k in range(n)]
        assert _counts(at, tag + ".wide", n) == [0] * n
    assert tm.retry_steps == 8 and tm.retried_reads > 0
    assert tm.wide_vote_steps == tm.wide_vote_reads == 0
    _assert_issued_ahead(rep, at)


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
        _, out, seen, _ = stream
    else:
        _, out, seen, _ = _spied_stream(dict(rep,
                                            chunks=rep["chunks"][:n]))
    assert [e for e in seen if e[0] not in ("issue", "wait", "issue.wide",
                                            "wait.wide")] == \
        _stage_order(n)
    assert [t for t, _, _ in out] == _sam(rep["records"][:n])
