"""Reads past ~80 kb in the port (ROADMAP.md C2, F3): the gact walk's run
entries are int32 where a count can pass int16's 8191 (the full-band retry
of the 100,352 bucket, band - W = 10061), where the JAX package raises;
the splice widens whichever side is narrower; the mapper counts its gact
steps and their int32 ones.  And the benchmark's human_chrX.ontul100k and
yeast.hifi10k cells: their inputs, and the metrics that read the new
counters and kernels.  CPU only, small shapes: the 100 kb bucket's shapes
are checked as configurations, the walk at a few hundred rows."""

import json
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import mutate_rows
from longreadmapper_tpu_torch.models import mapper as tmapper
from longreadmapper_tpu_torch.models.mapper import TorchMapper, _Cigars, \
    _Part, _Step, _widen_entries
from longreadmapper_tpu_torch.ops import gact as tg
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UL = 100352                     # the ultra-long cell's bucket


def _mapper():
    """A TorchMapper at --chunk-b 2048 over no index: its configs, counters
    and splice, not its steps (meta of chrX's .cat, n ~308.5 M)."""
    meta = SimpleNamespace(n=308_519_133, dollar_pos=1, hlen=14,
                           n_contigs=1, pos_dtype="int32", slim=False)
    return TorchMapper(SimpleNamespace(packed=torch.empty(0)), meta, [],
                       Params(), chunk_b=2048, device="cpu")


def _tiers(tm, L):
    """The configs of bucket L's first pass, full-band retry, saturation
    tier (gact only) and a wide vote class step."""
    first, retry = tm._step_for(L), tm._retry_step_for(L)
    out = {"first": first, "retry": retry,
           "wide": tm._wide_step_for(L, retry.vote_slots_max, 1)}
    if first.use_gact:
        out["sat"] = tm._sat_step_for(L)
    return out


# ------------------------------------------------------------ the shapes

@pytest.mark.parametrize("L,want", [
    (UL, {"first": 2, "retry": 4, "wide": 4, "sat": 2}),
    (50176, {"first": 2, "retry": 2, "wide": 2, "sat": 2}),
    (10240, {"first": 4, "retry": 2, "wide": 2})])
def test_entry_width_follows_the_shape(L, want):
    """tb_entry_bytes of every tier of a bucket: int32 for the 100,352
    bucket's full-band gact steps (band - W = 20096 - 10035 > 8191), int16
    for its first pass (10112 - 5017) and for every gact step of the 50 kb
    and 10 kb buckets; the resident 10 kb first pass int32 (L > 8191)."""
    tm = _mapper()
    tiers = _tiers(tm, L)
    assert {k: c.tb_entry_bytes for k, c in tiers.items()} == want
    for name, c in tiers.items():
        if c.use_gact:
            cmax = max(c.gact_tile, c.gact_band - c.gact_W)
            assert (cmax > 8191) == (c.tb_entry_bytes == 4), name
            assert c.entry_dtype == (torch.int32 if c.tb_entry_bytes == 4
                                     else torch.int16)
    if L == UL:
        first, retry = tiers["first"], tiers["retry"]
        assert tm._b_for(UL) == first.B == retry.B == 16
        assert (first.gact_W, first.gact_band) == (5017, 10112)
        assert (retry.gact_W, retry.gact_band) == (10035, 20096)
        assert all(c.use_gact for c in tiers.values())


def test_check_counts_takes_the_100kb_shapes_and_jax_refuses_them():
    """At the 100 kb retry's shape the port's bound (check_run_counts, the
    one both walks take) holds with int32 entries and refuses int16 ones;
    JAX's walk refuses the shape itself (its ops/gact.py:310 assert), the
    departure ROADMAP.md C records."""
    from longreadmapper_tpu.ops import gact as jg
    from longreadmapper_tpu_torch.ops.traceback import check_run_counts
    tm = _mapper()
    for c in (_tiers(tm, UL)["retry"], _tiers(tm, UL)["wide"]):
        T, W, band = c.gact_tile, c.gact_W, c.gact_band
        check_run_counts(max(T, band - W), c.entry_dtype, "counts")
        with pytest.raises(ValueError, match="8191"):
            check_run_counts(max(T, band - W), torch.int16, "counts")
        q = np.zeros((1, UL), np.int8)
        ckpt = np.zeros((UL // T + 1, 1, band), np.int32)
        with pytest.raises(AssertionError):
            jg.gact_traceback_c(q, q, ckpt, np.zeros(1, np.int32), T, W,
                                band)
    first = _tiers(tm, UL)["first"]
    check_run_counts(max(first.gact_tile, first.gact_band - first.gact_W),
                     torch.int16, "counts")
    check_run_counts(8191, torch.int16, "counts")
    with pytest.raises(ValueError, match=str((1 << 29) - 1)):
        check_run_counts(1 << 29, torch.int32, "counts")
    with pytest.raises(TypeError):
        check_run_counts(8, torch.int8, "counts")


# -------------------------------------------------------------- the walk

def _walk_inputs(seed, B, L, edits, pad):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = mutate_rows(rng, q, edits, pad=pad)
    lens = np.full(B, L - pad, np.int32)
    lens[1] = 0                                   # a dead lane
    lens[-1] = L - pad - 37                       # a shorter read
    return q, t, lens


def _decode(runs: torch.Tensor):
    eb = runs.element_size()
    return _Cigars()(runs.contiguous().numpy().view(np.int8), eb)


@pytest.mark.parametrize("T,group,scale", [(64, 1, 1), (128, 3, 1),
                                           (64, 16, 4)])
def test_int32_gact_walk_equals_int16_and_the_reference(T, group, scale):
    """gact_traceback_c, the function the 100 kb bucket's steps call, with
    its entry width as an argument: int32 runs hold the int16 runs'
    values, the same saturated flag and CIGARs; each walked lane's CIGAR
    spells its distance against its window, and that distance is the
    plain reference's banded distance (benchmark/reference.py)."""
    from benchmark.judge import cigar_cost
    from benchmark.reference import Reference
    B, L, W, band = 6, 512, 30, 128
    q, t, lens = _walk_inputs(T + group, B, L, L // 40, 16)
    tq, tt, tl = (torch.from_numpy(a) for a in (q, t, lens))
    ckpt, wcol = tg.gact_forward(tq, tt, T, W, band)
    r16, s16 = tg.gact_traceback_c(tq, tt, ckpt, tl, T, W, band, scale,
                                   group, entry_dtype=torch.int16)
    r32, s32 = tg.gact_traceback_c(tq, tt, ckpt, tl, T, W, band, scale,
                                   group, entry_dtype=torch.int32)
    assert r16.dtype == torch.int16 and r32.dtype == torch.int32
    assert torch.equal(r16.to(torch.int32), r32)
    assert bool(s16) == bool(s32) is False
    c16, c32 = _decode(r16), _decode(r32)
    assert c16 == c32
    ref = Reference.banded_ed(SimpleNamespace(dev=torch.device("cpu")),
                              [q[b, :lens[b]] for b in range(B)],
                              [t[b, :lens[b]] for b in range(B)], [W] * B)
    for b in range(B):
        n = int(lens[b])
        if n == 0:
            assert c32[b] == ""
            continue
        ed = int(wcol[n, b])
        assert ed == ref[b] and ed < W
        assert cigar_cost(c32[b], q[b, :n], t[b, :n]) == ed


def test_int32_gact_walk_holds_a_count_past_8191():
    """One tile of 8704 rows, a read that matches its window: one M-run of
    8704, past int16's count field.  int16 entries are refused, int32
    ones hold it."""
    L = T = 8704
    rng = np.random.default_rng(8704)
    q = torch.from_numpy(rng.integers(0, 4, (1, L)).astype(np.int8))
    lens = torch.tensor([L], dtype=torch.int32)
    ckpt, wcol = tg.gact_forward(q, q, T, 16, 128)
    assert int(wcol[L, 0]) == 0
    with pytest.raises(ValueError, match="8191"):
        tg.gact_traceback_c(q, q, ckpt, lens, T, 16, 128)
    runs, sat = tg.gact_traceback_c(q, q, ckpt, lens, T, 16, 128,
                                    entry_dtype=torch.int32)
    assert not bool(sat)
    assert int(runs[0, 0]) == L << 2
    assert _decode(runs) == [f"{L}M"]


def test_gact_setup_plain_takes_the_entry_width():
    """The walk's prepared state: the buffer of pads in the width asked
    for, the model of lanes_kernel<4> (two int32 words a pad pair) equal
    to it."""
    from longreadmapper_tpu_torch.ops import step as tstep
    import _glue_inputs as G
    lens = torch.tensor([5, 0, -2, 9], dtype=torch.int32)
    for dt, eb in ((torch.int16, 2), (torch.int32, 4)):
        st, buf = tstep.gact_setup(lens, 7, dt)
        want = tstep.gact_setup_plain(lens, 7, dt)
        assert buf.dtype == dt and buf.shape == (4, 14)
        assert torch.equal(st, want[0]) and torch.equal(buf, want[1])
        assert bool((buf == 3).all())
        m_st, m_buf = G.model_gact_setup(lambda b: int(lens[b]), 4, 7,
                                         threads=32, max_blocks=1, eb=eb)
        np.testing.assert_array_equal(m_st, st.numpy())
        np.testing.assert_array_equal(m_buf, buf.numpy())
    with pytest.raises(TypeError):
        tstep.gact_setup(lens, 7, torch.int8)


# ----------------------------------------------------- splice, counters

def _entries(cigar_ops, width):
    """Run entries (count << 2 | op) of `cigar_ops` [(count, op)] in
    reverse path order, padded with 3 to `width` entries."""
    e = [(n << 2) | "MID".index(op) for n, op in reversed(cigar_ops)]
    return np.array(e + [3] * (width - len(e)))


def _step(cfg, rows, sel):
    """A retry _Step of `cfg` whose blob holds `rows` (entry arrays)."""
    dt = np.int16 if cfg.tb_entry_bytes == 2 else np.int32
    ops = np.stack(rows).astype(dt).view(np.int8)
    meta = np.zeros((len(rows), cfg.meta_words), np.int32)
    blob = np.concatenate([meta.view(np.int8), ops], axis=1)
    return _Step(cfg, torch.from_numpy(blob),
                 torch.zeros((len(rows), 0), dtype=torch.int8), None, None,
                 None, None, sel=np.asarray(sel), wide=False)


@pytest.mark.parametrize("L", [UL, 10240])
def test_splice_widens_either_side(L):
    """_finish_overflow at the 100 kb bucket (an int16 first pass, an
    int32 retry: the first pass's rows widen) and at 10 kb (an int32
    first pass, an int16 retry: the retry's rows widen): every row comes
    out at int32, each read's CIGAR as its own step wrote it, the
    widening timed in phase_s["widen"] and a mapper.retry.widen span."""
    tm = _mapper()
    first, retry = tm._step_for(L), tm._retry_step_for(L)
    assert {first.tb_entry_bytes, retry.tb_entry_bytes} == {2, 4}
    mine = [[(90, "M"), (1, "I"), (9, "M")], [(100, "M")],
            [(40, "M"), (2, "D"), (60, "M")]]
    redo = [[(50, "M"), (1, "D"), (50, "M")]]
    dt = np.int16 if first.tb_entry_bytes == 2 else np.int32
    p = _Part(first, [("r%d" % i, "A" * 100, None) for i in range(3)], 0,
              None)
    p.meta = np.zeros((3, first.meta_words), np.int32)
    p.ops = np.stack([_entries(c, 6) for c in mine]).astype(dt).view(
        np.int8)
    p.eb = first.tb_entry_bytes
    p.retry = [_step(retry, [_entries(c, 8) for c in redo], [1])]
    with torch.profiler.profile() as prof:
        tm._finish_overflow(p)
    assert p.eb == 4 and not p.retry
    want = ["90M1I9M", "50M1D50M", "40M2D60M"]
    assert _Cigars()(p.ops, p.eb) == want
    assert tm.phase_s["widen"] > 0
    assert "mapper.retry.widen" in {e.name for e in prof.events()}


def test_widen_entries_keeps_values():
    ops = np.array([[4 * 8191 + 2, 3, -1, 7]], np.int16)
    got = _widen_entries(ops.view(np.int8), 2, 4).view(np.int32)
    np.testing.assert_array_equal(got, ops.astype(np.int32))
    assert _widen_entries(ops.view(np.int8), 2, 2) is not None
    with pytest.raises(AssertionError):
        _widen_entries(ops.view(np.int8), 4, 2)


def test_counters_count_gact_and_int32_steps():
    """_count: every packed step in raw_chunks or host_chunks, a gact step
    in gact_steps, an int32 one in int32_gact_steps too."""
    tm = _mapper()
    t = _tiers(tm, UL)
    for c in (t["first"], t["retry"], t["wide"], t["sat"],
              tm._step_for(10240), tm._retry_step_for(50176)):
        tm._count(c, None)
    tm._count(t["retry"], np.zeros(1))
    assert (tm.raw_chunks, tm.host_chunks) == (6, 1)
    assert (tm.gact_steps, tm.int32_gact_steps) == (6, 3)
    assert tm.phase_s["widen"] == 0.0


# ------------------------------------------------------------ benchmark

def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _traffic(name):
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")) as f:
        return json.load(f)


def test_new_cells_are_found_by_name():
    from benchmark.run import cell_of, reader
    spec = _spec()
    for name, config, traffic in (
            ("human_chrX.ontul100k", "human_chrX", "ontul100k"),
            ("yeast.hifi10k", "yeast", "hifi10k")):
        cell = cell_of(spec, name)
        assert cell["workload"]["chips"] == 1
        assert cell["config"]["name"] == config
        assert cell["traffic"]["name"] == traffic
        names = {m["name"] for m in cell["per_layer"]}
        assert "step.int32_gact_step_share" in names
        for m in cell["per_layer"] + cell["end_to_end"]:
            assert callable(reader(m["name"]))
    conf = {c["name"]: c for c in spec["configs"]}["human_chrX"]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert all(k in cfg["reduced"] for k in conf["reduced"])


def test_ul_and_hifi_traffic_draw_in_bounds():
    """ontul100k: 16 reads a chunk (the bucket's B) of 98,305-100,352
    bases; hifi10k: ont10k's lengths at HiFi identity, the Beta of mean
    0.99873 and deviation 0.00099, which is Q ~ Normal(30, 3) as 1 -
    10^(-Q/10)."""
    from benchmark.traffic import draw_identity, make_genome, make_pool, \
        rng_for
    ul, hifi, ont = (_traffic(n) for n in ("ontul100k", "hifi10k", "ont10k"))
    assert ul["chunk_reads"] == _mapper()._b_for(UL) == 16
    g = make_genome({"contigs": [["c", 400000]]}, 3)
    p = make_pool(g, dict(ul, pool_chunks=1), 3)
    assert len(p.seqs) == 16
    assert all(98305 <= len(s) <= 100352 for s in p.seqs)
    assert [len(s) for s in p.seqs] == p.lengths.tolist()
    assert hifi["lengths"] == ont["lengths"]
    ph = make_pool(g, dict(hifi, pool_chunks=1), 4)
    assert all(8193 <= len(s) <= 10240 for s in ph.seqs)
    x = draw_identity(rng_for(1, 2), hifi["identity"], 400000)
    assert x.max() <= 1.0
    assert abs(x.mean() - 0.99873) < 1e-5
    assert abs(x.std() - 0.00099) < 1e-5
    qv = np.random.default_rng(30).normal(30, 3, 2_000_000)
    ident = 1 - 10 ** (-qv / 10)
    assert abs(ident.mean() - hifi["identity"]["mean"]) < 1e-5
    assert abs(ident.std() - hifi["identity"]["stdev"]) < 1e-5


def test_dxz1_where_the_configuration_puts_it():
    """human_chrX.json's DXZ1: 1,500 identical 2,057 bp copies head to
    tail inside chrX from 57.8 Mb; the generator lays them so (on chrX cut
    to 3.2 Mb, the array at 50,000: the whole contig is too large to draw
    here)."""
    from benchmark.traffic import make_genome
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "human_chrX.json")) as f:
        cfg = json.load(f)
    spec = cfg["genome"]
    assert spec["contigs"] == [["chrX", 154259566]]
    assert spec["total_bp"] == 154259566
    (dxz1,) = spec["repeats"]
    assert (dxz1["family"], dxz1["length"], dxz1["copies"],
            dxz1["placement"], dxz1["contig"], dxz1["at"]) == (
        "DXZ1", 2057, 1500, "tandem", "chrX", 57800000)
    assert dxz1["at"] + 1500 * 2057 <= 154259566
    cut = dict(spec, contigs=[["chrX", 3200000]],
               repeats=[dict(dxz1, at=50000)])
    g = make_genome(cut, 6)
    n, at = 2057, 50000
    unit = g.codes[at:at + n]
    array = g.codes[at:at + 1500 * n].reshape(1500, n)
    assert (array == unit).all()
    assert not np.array_equal(g.codes[at - n:at], unit)
    assert not np.array_equal(g.codes[at + 1500 * n:at + 1501 * n], unit)
    assert [(f, a, b) for f, a, b in g.copies] == [
        ("DXZ1", at + k * n, at + (k + 1) * n) for k in range(1500)]
    gc = np.isin(np.delete(g.codes, np.s_[at:at + 1500 * n]), (1, 2))
    assert abs(gc.mean() - 0.395) < 0.002


def _run(kernels=(), counters=None):
    chunks = [dict(lengths=[100000] * 16, retried=6, end_s=9.0)] * 4
    return dict(chunks=chunks, window_s=10.0,
                counters=counters if counters is not None else {},
                trace=dict(window=(0.0, 10.0), kernels=list(kernels),
                           device_ops=list(kernels), host=[]))


SETUP = "void (anonymous namespace)::lanes_kernel<{}>(SetupArgs)"
WALK = ("void (anonymous namespace)::gact_walk_kernel<{}>(unsigned int "
        "const*, unsigned int const*, int*, int*, int*, PairOf<{}>::T*)")


def test_new_metrics_read_and_fall_silent_without_their_sources():
    """Each new metric reads its share or time from a run that has its
    source, and None from a program without it (the parent's setup
    kernel names no width; it keeps no `widen` key)."""
    from benchmark.run import reader
    share = reader("step.int32_gact_step_share")
    widen = reader("mapper.widen_ms_per_chunk")
    ks = [(SETUP.format(2), 1.0, 1.1), (SETUP.format(4), 2.0, 2.1),
          (SETUP.format(4), 3.0, 3.1), (SETUP.format(4), 10.5, 10.6)]
    assert share(_run(ks)) == pytest.approx(100 * 2 / 3)
    assert share(_run([(SETUP.format(2), 1.0, 1.1)])) == 0.0
    assert share(_run([("(anonymous namespace)::lanes_kernel(SetupArgs)",
                        1.0, 1.1)])) is None
    assert share(dict(_run(), trace=None)) is None
    assert widen(_run(counters={"phase.widen": 0.02})) == pytest.approx(5)
    assert widen(_run(counters={"phase.retry": 1.0})) is None


def test_int32_walk_ms_reads_the_int32_instantiation_alone():
    """walk.gact_int32_ms_per_chunk: the window's time of
    gact_walk_kernel<int> (clipped to the window) over its completed
    chunks; the int16 instantiation and walk_c are not counted; None
    from a program whose gact walk has one width (the parent's untemplated
    kernel), without a trace or without chunks."""
    from benchmark.run import reader
    ms = reader("walk.gact_int32_ms_per_chunk")
    w32, w16 = WALK.format("int", "int"), WALK.format("short", "short")
    ks = [(w32, 1.0, 1.5), (w16, 2.0, 4.0), (w32, 9.8, 10.4),
          ("void (anonymous namespace)::walk_c_kernel<int, true>(WalkArgs)",
           5.0, 6.0), (SETUP.format(4), 6.0, 6.5)]
    assert ms(_run(ks)) == pytest.approx(0.7 / 4 * 1e3)
    assert ms(_run(ks[1:2] + ks[3:])) is None
    assert ms(_run([("void (anonymous namespace)::gact_walk_kernel("
                     "unsigned int const*)", 1.0, 2.0)])) is None
    assert ms(dict(_run(ks), trace=None)) is None
    assert ms(dict(_run(ks), chunks=[])) is None


# a cell small enough for the CPU whose reads cross repeat copies at HiFi
# identity: one contig, half of it six identical copies of one family,
# reads of the 3072 bucket, hlen 12
VOTE_CELL = dict(
    workload={"name": "tiny_vote", "chips": 1},
    config={"genome": {"contigs": [["c1", 50000]], "gc": 0.4,
                       "repeats": [{"family": "mobile", "length": 4000,
                                    "copies": 6,
                                    "placement": "scattered"}]},
            "mapper": {"seed_len": 20, "thres": 300, "chunk_b": 24,
                       "hlen": 12}},
    traffic={"lengths": {"mean": 15000, "stdev": 13000, "min": 2049,
                         "max": 3072},
             "identity": {"mean": 0.99873, "max": 1.0, "stdev": 0.00099},
             "errors": {"sub": 1 / 3, "ins": 1 / 3, "dele": 1 / 3},
             "chunk_reads": 8, "reverse_share": 0.5, "pool_chunks": 3,
             "qual": "I", "check": {"reads": 16, "keep_share": 1.0}})


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_vote_control_fails_the_comparison(seed):
    """benchmark/control_vote.py: the plain reference without the exact
    vote tier (a read whose widest row passes the compact slots reported
    unmapped) gets records wrong, and only those reads' flag and ED."""
    from benchmark.control_vote import control_counts
    c = control_counts(VOTE_CELL, seed, "cpu")
    assert c["sampled"] == 16
    assert c["sampled_over_compact"] >= 1
    assert c["records_wrong"] >= 1
    assert c["flag"] == c["records_wrong"] == c["ed"]
    assert c["pos"] == c["contig"] == c["seq"] == 0


@pytest.mark.parametrize("n,hlen", [(24_312_331, 14), (308_519_133, 14),
                                    (9_283_245, 14), (100_001, 12)])
def test_vote_control_slots_are_the_compact_tiers(n, hlen):
    """control_vote.compact_slots, which imports nothing of the program,
    gives the first pass's vote_slots at every bucket of the cells."""
    from benchmark.control_vote import compact_slots
    meta = SimpleNamespace(n=n, dollar_pos=1, hlen=hlen, n_contigs=1,
                           pos_dtype="int32", slim=False)
    tm = TorchMapper(SimpleNamespace(packed=torch.empty(0)), meta, [],
                     Params(), chunk_b=2048, device="cpu")
    for L in (1024, 3072, 10240, 50176, UL):
        assert compact_slots(L, n, 20, hlen) == tm._step_for(L).vote_slots
