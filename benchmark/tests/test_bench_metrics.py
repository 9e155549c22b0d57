"""The metric arithmetic on synthetic records: the 95th percentile over
every chunk, the idle share from overlapping device intervals, kernel time
by layer through the name table, the DP's cells from the reads' real
lengths, and readers that find nothing return nothing."""

import json
import os

import pytest

from benchmark import devtrace, peaks, reduce
from benchmark.run import BENCH, reader

TABLE = json.load(open(os.path.join(BENCH, "kernel_layers.json")))


def _run(**over):
    run = dict(setup_s=20.0, window_s=10.0, chunks=[], peak_bytes=0,
               counters={"retried_reads": 0, "phase.prepare": 0.0,
                         "phase.dispatch": 0.0, "phase.assemble": 0.0,
                         "phase.fetch": 0.0},
               layers=TABLE)
    run.update(over)
    return run


def _chunk(lat, lengths=(9000, 10000), retried=0, reads=2, end_s=0.5):
    return dict(latency_s=lat, lengths=list(lengths), reads=reads,
                returned=reads, bases=sum(lengths), retried=retried,
                end_s=end_s)


def test_p95_is_over_all_chunks():
    chunks = [_chunk(i / 1000) for i in range(1, 101)]
    # inclusive quantiles of 1..100 ms: 95.05 ms
    assert reader("chunk_p95_ms")(_run(chunks=chunks)) == pytest.approx(95.05)
    # one slow chunk among many moves the tail, not a median of pieces
    slow = chunks[:94] + [_chunk(1.0)] * 6
    assert reader("chunk_p95_ms")(_run(chunks=slow)) == pytest.approx(1000.0)
    assert reader("chunk_p95_ms")(_run()) is None


def test_bases_per_s_counts_the_window_chunks():
    chunks = [_chunk(0.1, lengths=(1_000_000, 1_000_000))] * 5
    assert reader("bases_per_s")(_run(chunks=chunks)) == pytest.approx(1.0)


def test_idle_share_from_overlapping_intervals():
    ops = [("void a_kernel(x)", 0.0, 1.0), ("void b_kernel(x)", 0.5, 2.0),
           ("Memcpy HtoD (Pinned -> Device)", 3.0, 4.0),
           ("void c_kernel(x)", 4.5, 6.0)]          # past the window's end
    tr = dict(window=(0.0, 5.0), kernels=[o for o in ops if "Memcpy" not in
                                          o[0]], device_ops=ops, host=[])
    assert reduce.busy_s([(a, b) for _, a, b in ops], 0.0, 5.0) == 3.5
    assert reader("device.idle_share")(_run(trace=tr)) == pytest.approx(30.0)
    assert reduce.gaps([(a, b) for _, a, b in ops], 0.0, 5.0) == [
        (2.0, 3.0), (4.0, 4.5)]


def test_layer_time_through_the_name_table():
    ops = [("void (anonymous namespace)::band_dp_wide_kernel<16, true>(A)",
            0.0, 0.004),
           ("void band_scores_cluster_kernel<2>(B)", 0.004, 0.010),
           ("void walk_c_kernel<int, true>(W)", 0.010, 0.011),
           # not the port's: counted busy, in no layer
           ("void at::native::reduce_kernel<512, 1>(R)", 0.011, 0.020)]
    tr = dict(window=(0.0, 0.05), kernels=ops, device_ops=ops, host=[])
    chunks = [_chunk(0.1)] * 2
    run = _run(trace=tr, chunks=chunks)
    assert reader("dp.kernel_ms_per_chunk")(run) == pytest.approx(5.0)
    assert reader("walk.kernel_ms_per_chunk")(run) == pytest.approx(0.5)
    assert reader("seed_vote.kernel_ms_per_chunk")(run) is None
    assert reader("glue.kernel_ms_per_chunk")(run) is None
    assert reader("device.idle_share")(run) == pytest.approx(60.0)
    assert reduce.kernel_base("void xband_dp_kernel(A)", TABLE) is None
    assert reduce.kernel_base("void band_dp_kernel<1>(A)", TABLE) == \
        "band_dp_kernel"


def test_dp_cells_from_real_lengths():
    # 10 kb bucket: first pass at W 512 (band 1025), retry at W 1024
    ch = _chunk(0.1, lengths=(9000, 10000), retried=1)
    cells = (9000 + 10000) * 1025 + 9500 * 2049
    nbytes = 2 * (9000 + 10000) + 2 * 9500
    assert reduce.dp_bound_s([ch]) == pytest.approx(
        peaks.bound_s(cells, nbytes))
    assert peaks.bound_s(cells, nbytes) == pytest.approx(
        cells * 12 / (132 * 64 * 1.98e9))
    # the same reads padded to the bucket count the same cells
    ops = [("void band_dp_wide_kernel<1>(A)", 0.0, 0.001)]
    run = _run(trace=dict(window=(0.0, 1.0), kernels=ops, device_ops=ops,
                          host=[]), chunks=[ch])
    share = reader("dp_roofline")(run)
    assert share == pytest.approx(100 * peaks.bound_s(cells, nbytes) / 0.001)
    # DP time past the last completed chunk's yield is the work of chunks
    # still in flight at the close: not counted
    late = ops + [("void band_scores_kernel<1>(A)", 0.6, 0.9)]
    run = _run(trace=dict(window=(0.0, 1.0), kernels=late, device_ops=late,
                          host=[]), chunks=[ch])
    assert reader("dp_roofline")(run) == pytest.approx(share)
    # 1 kb reads run the full band in their first pass
    one = _chunk(0.1, lengths=(1000,), reads=1)
    assert reduce.dp_bound_s([one]) == pytest.approx(
        peaks.bound_s(1000 * (2 * 102 + 1), 2000))


def test_readers_find_nothing_to_read():
    run = _run()
    for name in ("dp_roofline", "dp.kernel_ms_per_chunk",
                 "device.idle_share", "mapper.host_ms_per_chunk",
                 "mapper.retried_read_share", "bases_per_s"):
        assert reader(name)(run) is None, name


def test_a_counter_the_program_dropped_silences_its_metrics():
    c = {"retried_reads": None, "phase.prepare": 0.2, "phase.dispatch": 0.3}
    ops = [("void band_dp_wide_kernel<1>(A)", 0.0, 0.001)]
    tr = dict(window=(0.0, 1.0), kernels=ops, device_ops=ops, host=[])
    run = _run(counters=c, trace=tr,
               chunks=[_chunk(0.1, reads=2, retried=None)])
    assert reader("mapper.retried_read_share")(run) is None
    assert reader("mapper.host_ms_per_chunk")(run) is None
    assert reader("dp_roofline")(run) is None
    assert reader("dp.kernel_ms_per_chunk")(run) is not None


def test_mapper_counters_per_chunk():
    c = {"retried_reads": 4, "phase.prepare": 0.2, "phase.dispatch": 0.3,
         "phase.assemble": 0.5, "phase.fetch": 9.0}
    run = _run(counters=c, chunks=[_chunk(0.1, reads=200)] * 10)
    assert reader("mapper.host_ms_per_chunk")(run) == pytest.approx(100.0)
    assert reader("mapper.retried_read_share")(run) == pytest.approx(0.2)


def test_breakdown_names_what_the_host_did():
    ops = [("void (anonymous namespace)::band_dp_wide_kernel<1>(A)", 0.0,
            1.0), ("void pack_kernel(P)", 2.0, 2.5)]
    host = [("mapper.fetch", 0.9, 2.1, -1),
            ("cudaEventSynchronize", 1.0, 1.9, 0),
            ("mapper.assemble", 2.6, 3.0, -1)]
    tr = dict(window=(0.0, 3.0), kernels=ops, device_ops=ops, host=host)
    b = devtrace.breakdown(tr)
    assert b["device_ops"] == [["band_dp_wide_kernel", 1.0],
                               ["pack_kernel", 0.5]]
    assert b["idle_gaps"][0] == [
        "mapper.fetch/cudaEventSynchronize (1 gaps)", 1.0]
    assert b["idle_gaps"][1][0] == "mapper.assemble/python (1 gaps)"
    assert b["idle_gaps"][1][1] == pytest.approx(0.5)
