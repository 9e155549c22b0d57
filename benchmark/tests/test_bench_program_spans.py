"""The readers of the program's own spans and device counters on synthetic
runs: the first pass's and the retry's device time, the host's wait in the
retry's copies, and the device's idle time under the SAM assembly; each
returns nothing where the program or the trace does not give it."""

import pytest

from benchmark.run import reader

COUNTERS = ("step.first_pass_device_ms_per_chunk",
            "step.retry_device_ms_per_chunk",
            "mapper.retry_wait_ms_per_chunk")
KEYS = {"step.first_pass_device_ms_per_chunk": "phase.first_pass_device",
        "step.retry_device_ms_per_chunk": "phase.retry_device",
        "mapper.retry_wait_ms_per_chunk": "phase.retry_wait"}
IDLE = "mapper.assemble_idle_ms_per_chunk"


def _chunk():
    return dict(latency_s=0.5, lengths=[50000], reads=1, returned=1,
                bases=50000, retried=0, end_s=0.5)


def _run(n_chunks=4, counters=None, trace=None):
    run = dict(setup_s=20.0, window_s=10.0, peak_bytes=0,
               chunks=[_chunk() for _ in range(n_chunks)],
               counters=dict(counters or {}))
    if trace is not None:
        run["trace"] = trace
    return run


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_over_completed_chunks(name):
    run = _run(4, {KEYS[name]: 0.2})
    assert reader(name)(run) == pytest.approx(50.0)
    assert reader(name)(_run(8, {KEYS[name]: 0.2})) == pytest.approx(25.0)


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_missing_reads_none(name):
    # the parent's mapper keeps no such phase key; a window with no
    # completed chunk has nothing to divide by
    assert reader(name)(_run(4, {"phase.fetch": 1.0})) is None
    assert reader(name)(_run(0, {KEYS[name]: 0.2})) is None


def _trace(host, device_ops, window=(0.0, 10.0)):
    return dict(window=window, kernels=device_ops, device_ops=device_ops,
                host=host)


def test_idle_under_the_assembly():
    ops = [("void band_scores_cluster_kernel<2>(A)", 0.0, 1.0),
           ("Memcpy DtoH (Device -> Pinned)", 3.0, 4.0),
           ("void band_dp_wide_kernel<16, true>(B)", 6.0, 7.5)]
    host = [
        # the program's span with the benchmark's own of the same name
        # nested inside it, and its sub-spans: merged, 0.5-2.5
        ("mapper.assemble", 0.5, 2.5, -1),
        ("mapper.assemble", 0.8, 2.4, 0),
        ("mapper.assemble.cigar", 0.9, 1.2, 1),
        ("mapper.assemble.records", 1.2, 2.3, 1),
        # partly over the device's copy: idle 2.8-3.0 and 4.0-4.5
        ("mapper.assemble", 2.8, 4.5, -1),
        # another span while the device idles is not the assembly's
        ("mapper.fetch", 4.5, 5.5, -1),
        # past the window's end: clipped to 9.5-10
        ("mapper.assemble", 9.5, 11.0, -1)]
    run = _run(2, trace=_trace(host, ops))
    # (1.0-2.5) 1.5 + 0.2 + 0.5 + 0.5 = 2.7 s over 2 chunks
    assert reader(IDLE)(run) == pytest.approx(1350.0)


def test_idle_under_the_assembly_needs_the_programs_spans():
    ops = [("void band_dp_wide_kernel<16, true>(B)", 0.0, 1.0)]
    # only the benchmark's own wrapper (the parent's trace): none
    host = [("mapper.assemble", 1.0, 2.0, -1)]
    assert reader(IDLE)(_run(2, trace=_trace(host, ops))) is None
    assert reader(IDLE)(_run(2)) is None
    host += [("mapper.assemble.records", 1.1, 1.9, 0)]
    assert reader(IDLE)(_run(0, trace=_trace(host, ops))) is None
    assert reader(IDLE)(_run(2, trace=_trace(host, ops))) == \
        pytest.approx(500.0)
    # a window with no device operation is idle under the whole span
    assert reader(IDLE)(_run(1, trace=_trace(host, []))) == \
        pytest.approx(1000.0)
