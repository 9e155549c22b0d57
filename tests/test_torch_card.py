"""The port on the card against the port on the CPU, for the parts that
the smoke's main path does not reach alone: the lchash's device build, the
device read encode, the forced pos64 and slim layouts, the vote-overflow
tier (bit 0: reads inside a tandem repeat overflow the compact vote
slots) and the gact saturation tier (bit 1, forced on a submitted chunk
as tests/test_torch_long.py forces it on the CPU); and, off the map path,
the card-side suffix-array build and the affine scorer; map_stream
against map_stream_sam; the stream's overflow retry running on the
card under an earlier chunk's assembly; and 10 kb and 50 kb streams over
high-copy repeat families, whose reads take the wide vote classes, and a
stream of 98-100 kb reads over a tandem array of 320 copies (int32 run
entries in the full-band retry), judged read by read by the benchmark's
plain reference (benchmark/reference.py).  Every SAM is byte-identical between the
devices and every CIGAR is checked against the genome.

Card-only: the tests skip where torch.cuda.is_available() is false, and
import no JAX, so they run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card.py
"""

import gc
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_parity import cigar_check
from longreadmapper_tpu_torch.formats.lch import read_lch
from longreadmapper_tpu_torch.index.device import (DeviceIndex, bwt_arrays,
                                                   load_device_index)
from longreadmapper_tpu_torch.index.fmi import FMIndex
from longreadmapper_tpu_torch.index.lchash import lc_build_device
from longreadmapper_tpu_torch.index.sa import sa_build_device, suffix_array
from longreadmapper_tpu_torch.mapping.pipeline import raw_map_step
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops.affine import affine_align, \
    banded_sw_affine
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's card path")


def _genome(seed: int, n: int, motif_repeats: int = 0) -> str:
    rng = np.random.default_rng(seed)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    if not motif_repeats:
        return rand(n)
    return rand(n // 2) + rand(60) * motif_repeats + rand(n // 2)


def _index(tmp_path, genome: str, hlen: int) -> str:
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + genome + "\n")
    build_index(fa, Params(hlen=hlen), verbose=False, device=None)
    return fa


def _reads(seed, genome, n, L, sub, lo=0, hi=None, junk=False):
    rng = np.random.default_rng(seed)
    hi = (hi or len(genome)) - L - 1
    out = []
    for i in range(n):
        p = int(rng.integers(lo, hi))
        s = np.frombuffer(genome[p:p + L].encode(), np.uint8).copy()
        m = rng.random(L) < sub
        s[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                             int(m.sum()))]
        s = s.tobytes().decode()
        if i % 2:
            s = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        if junk and i % 3 == 0:
            s = s[:10] + s[10:60].lower() + "NNNNNNNN" + s[68:]
        out.append((f"r{i}", s, "I" * L))
    return out


def _maps(fa, params, reads, chunk_b, **load):
    """SAM text and mapper of `reads` through TorchMapper on the card and
    on the CPU, over the index loaded with `load`."""
    out = {}
    for dev in ("cuda", "cpu"):
        idx, meta, mta = load_device_index(fa, dev, verbose=False, **load)
        tm = TorchMapper(idx, meta, mta, params, chunk_b=chunk_b,
                         device=dev)
        text = "".join(t for t, _, _ in tm.map_stream_sam(iter([reads])))
        out[dev] = (text, tm)
    return out


def _check_records(text, genome, n, min_valid):
    recs = [line.split("\t") for line in text.splitlines()]
    assert len(recs) == n
    valid = [r for r in recs if r[1] in ("0", "16")]
    assert len(valid) >= min_valid
    for r in valid:
        assert cigar_check(r, genome) == (len(r[9]),
                                          int(r[11][len("ED:I:"):])), r[0]


@pytest.mark.cuda
@pytest.mark.parametrize("hlen,seed_dtype", [(8, None), (10, None),
                                             (9, torch.int64)])
def test_lc_build_device_card_matches_cpu_and_host(tmp_path, hlen,
                                                   seed_dtype):
    _card()
    fa = _index(tmp_path, _genome(hlen, 40000), hlen)
    fmi = FMIndex.read(fa + ".cat", with_sa=False)
    arrays, dollar_pos = bwt_arrays(fmi)
    arrays["c4"] = fmi.c4().astype(np.int32)
    _, host = read_lch(fa + ".cat.lch")
    got = {}
    for dev, chunk in (("cuda", 1 << 12), ("cpu", 5000)):
        idx = DeviceIndex.from_arrays(arrays, dev)
        got[dev] = lc_build_device(idx.packed, idx.occ_samp, idx.c4,
                                   dollar_pos, fmi.length, hlen,
                                   chunk=chunk, pos_dtype=seed_dtype)
    np.testing.assert_array_equal(got["cuda"], got["cpu"])
    np.testing.assert_array_equal(got["cuda"], host)


@pytest.mark.cuda
def test_raw_step_card_matches_cpu(tmp_path):
    _card()
    genome = _genome(3, 100000)
    fa = _index(tmp_path, genome, 9)
    params = Params(hlen=9)
    reads = _reads(4, genome, 30, 500, 0.04, junk=True)
    outs = {}
    for dev in ("cuda", "cpu"):
        idx, meta, mta = load_device_index(fa, dev, verbose=False)
        tm = TorchMapper(idx, meta, mta, params, chunk_b=32, device=dev)
        cfg = tm._step_for(512)
        raw, _, lens, limits = tm._pack_raw(reads, 512, 32)
        step = raw_map_step(cfg, idx, *(torch.from_numpy(a).to(dev)
                                         for a in (raw, lens, limits)))
        outs[dev] = ({k: v.cpu() for k, v in step.items()},
                     [r.to_sam() for r in tm.map_chunk(reads)], tm)
    for k in ("blob", "ops_tail"):
        assert torch.equal(outs["cuda"][0][k], outs["cpu"][0][k]), k
    assert outs["cuda"][1] == outs["cpu"][1]
    tm = outs["cuda"][2]
    assert (tm.raw_chunks, tm.host_chunks) == (
        1 + tm.retry_steps + tm.retried_sat_chunks, 0)
    _check_records("".join(outs["cuda"][1]), genome, 30, 27)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [dict(slim=True),
                                    dict(force_pos_dtype="int64"),
                                    dict(force_pos_dtype="int64",
                                         slim=True)])
def test_layouts_card_match_cpu_and_full(tmp_path, layout):
    _card()
    genome = _genome(5, 120000)
    fa = _index(tmp_path, genome, 9)
    params = Params(hlen=9)
    reads = _reads(6, genome, 40, 700, 0.03)
    full = _maps(fa, params, reads, 40)
    out = _maps(fa, params, reads, 40, **layout)
    assert out["cuda"][0] == out["cpu"][0] == full["cuda"][0]
    meta = out["cuda"][1].meta
    assert meta.slim == layout.get("slim", False)
    assert meta.pos_dtype == layout.get("force_pos_dtype", "int32")
    _check_records(out["cuda"][0], genome, 40, 38)


@pytest.mark.cuda
def test_vote_overflow_tier_card_matches_cpu(tmp_path):
    """Reads inside a 40x tandem repeat overflow the compact tier's vote
    slots (bit 0) and re-run through the exact tier on both devices."""
    _card()
    genome = _genome(7, 12000, motif_repeats=40)
    fa = _index(tmp_path, genome, 6)
    reads = _reads(8, genome, 16, 200, 0.02, lo=5000, hi=9400)
    out = _maps(fa, Params(hlen=6), reads, 16)
    (text, tm), (cpu_text, cpu_tm) = out["cuda"], out["cpu"]
    assert text == cpu_text
    assert tm.retried_reads == cpu_tm.retried_reads > 0
    assert tm.overflow_reads == cpu_tm.overflow_reads
    _check_records(text, genome, 16, 8)


@pytest.mark.cuda
def test_stream_device_time_by_events_on_card(tmp_path):
    """The mapper's device keys (phase_s first_pass_device, retry_device:
    CUDA events read after the syncs the stream makes anyway) on the
    vote-overflow tier's stream: both above 0 and together inside the
    stream's wall time; and a 1 kb chunk's first pass, issued behind a
    sleeping kernel so that the card never waits for the host inside it,
    within 10% of its kernels and copies in a torch.profiler trace."""
    _card()
    genome = _genome(7, 12000, motif_repeats=40)
    fa = _index(tmp_path, genome, 6)
    reads = _reads(8, genome, 16, 200, 0.02, lo=5000, hi=9400)
    idx, meta, mta = load_device_index(fa, "cuda", verbose=False)
    tm = TorchMapper(idx, meta, mta, Params(hlen=6), chunk_b=16,
                     device="cuda")
    first = [t for t, _, _ in tm.map_stream_sam(iter([reads]))]
    before = dict(tm.phase_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [t for t, _, _ in tm.map_stream_sam(iter([reads] * 4))]
    wall = time.perf_counter() - t0
    d = {k: tm.phase_s[k] - before[k] for k in tm.phase_s}
    assert got == first * 4 and tm.retried_reads > 0
    print(f"[card] overflow stream of 4 chunks: first_pass_device "
          f"{d['first_pass_device'] * 1e3:.4f} ms, retry_device "
          f"{d['retry_device'] * 1e3:.4f} ms, retry_wait "
          f"{d['retry_wait'] * 1e3:.4f} ms, wall {wall * 1e3:.4f} ms")
    assert d["first_pass_device"] > 0 and d["retry_device"] > 0
    assert d["first_pass_device"] + d["retry_device"] <= wall
    assert d["retry"] >= d["retry_wait"] > 0

    big = TorchMapper(idx, meta, mta, Params(hlen=6), chunk_b=2048,
                      device="cuda")
    chunk = _reads(14, genome, 2048, 1000, 0.02)
    big.map_chunk(chunk)
    torch.cuda.synchronize()
    f0 = big.phase_s["first_pass_device"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000_000)
        pending = big.submit_chunk(chunk)
        torch.cuda.synchronize()
    big.collect_chunk(pending)
    event_s = big.phase_s["first_pass_device"] - f0
    ops = sorted((e.time_range.end - e.time_range.start) / 1e6
                 for e in prof.events()
                 if e.device_type.name == "CUDA"
                 and not getattr(e, "is_user_annotation", False)
                 and not e.name.startswith("mapper."))
    assert ops[-1] > 0.02           # the sleeping kernel, not the step's
    traced_s = sum(ops[:-1])
    print(f"[card] 1 kb first pass (B 2048): events {event_s * 1e3:.4f} "
          f"ms, traced kernels and copies {traced_s * 1e3:.4f} ms in "
          f"{len(ops) - 1} operations")
    assert abs(event_s - traced_s) <= 0.1 * traced_s


def _force_gact(tm):
    tm._cfgs[3072] = replace(tm._step_for(3072), mid_dirs_budget=0)
    assert tm._step_for(3072).use_gact


@pytest.mark.cuda
def test_gact_saturation_tier_card_matches_cpu(tmp_path):
    """A gact chunk flagged with bit 1 re-runs through the 4x run-buffer
    tier and comes back with the records of the direct mapping, on the
    card as on the CPU."""
    _card()
    genome = _genome(9, 60000)
    fa = _index(tmp_path, genome, 10)
    params = Params(hlen=10)
    reads = _reads(10, genome, 4, 2600, 0.02)
    texts = {}
    for dev in ("cuda", "cpu"):
        idx, meta, mta = load_device_index(fa, dev, verbose=False)
        tm = TorchMapper(idx, meta, mta, params, chunk_b=4, device=dev)
        _force_gact(tm)
        base = [r.to_sam() for r in tm.map_chunk(reads)]
        pending = tm.submit_chunk(reads)
        for part in pending:
            first = part.first
            if first.copied is not None:
                first.copied.synchronize()      # the D2H copy has landed
            mw = 4 * part.cfg.meta_words
            blob = first.blob.numpy()           # pinned host memory
            meta_w = np.ascontiguousarray(blob[:, :mw]).view(np.int32)
            meta_w[:, -1] |= 2
            blob[:, :mw] = meta_w.view(np.int8)
        got = [r.to_sam() for r in tm.collect_chunk(pending)]
        assert got == base
        assert (tm.retried_sat_chunks, tm.overflow_reads) == (1, 0)
        texts[dev] = "".join(got)
    assert texts["cuda"] == texts["cpu"]
    _check_records(texts["cuda"], genome, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "satellite", "dollar"])
def test_sa_build_device_card_matches_cpu_and_host(case):
    _card()
    rng = np.random.default_rng(11)
    if case == "random":
        codes = rng.integers(0, 4, 300000).astype(np.uint8)
    elif case == "satellite":
        codes = np.tile(np.array([0, 1, 2, 3, 2, 1, 0], np.uint8), 3000)
    else:
        codes = np.zeros(0, np.uint8)
    codes = np.concatenate([codes, [4]]).astype(np.uint8)
    got = sa_build_device(codes, device="cuda")
    rounds = sa_build_device.rounds
    np.testing.assert_array_equal(got, sa_build_device(codes, device="cpu"))
    assert sa_build_device.rounds == rounds
    text = np.frombuffer(b"ACGT$", np.uint8)[codes]
    np.testing.assert_array_equal(got, suffix_array(text))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,band", [(64, 256, 26, 128),
                                        (16, 512, 80, 640)])
def test_banded_sw_affine_card_matches_cpu(B, L, W, band):
    _card()
    rng = np.random.default_rng(B + band)
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    t = q.copy()
    m = rng.random((B, L)) < 0.05
    t[m] = (t[m] + 1) % 4
    t[1] = np.roll(t[1], 3)                   # a shifted diagonal
    q[2, 100:] = 4                            # a tie along N
    q[3] = 0                                  # a homopolymer row
    t[3] = 0
    t[-1] = 5                                 # nothing scores
    got = banded_sw_affine(torch.from_numpy(q).cuda(),
                           torch.from_numpy(t).cuda(), W, band)
    want = banded_sw_affine(torch.from_numpy(q), torch.from_numpy(t), W,
                            band)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g.cpu(), w)
    # band 2W + 1 holds the scorer to the traceback's best cell
    got = banded_sw_affine(torch.from_numpy(q).cuda(),
                           torch.from_numpy(t).cuda(), W, 2 * W + 1)
    sc, ei, ej = (x.cpu().numpy() for x in got)
    for b in range(8):
        score, span, _ = affine_align(q[b], t[b], W)
        assert (sc[b], ei[b], ej[b]) == ((score, span[1], span[3])
                                         if score else (0, 0, 0)), b


@pytest.mark.cuda
def test_map_stream_card_matches_sam_and_cpu(tmp_path):
    """map_stream on the card: its records, chunk by chunk (3 chunks and a
    ragged 4th, so the depth-3 queue fills and drains), spell the SAM of
    map_stream_sam on the card, and both equal the CPU port's."""
    _card()
    genome = _genome(12, 100000)
    fa = _index(tmp_path, genome, 9)
    params = Params(hlen=9)
    reads = _reads(13, genome, 100, 600, 0.03)
    chunks = [reads[s:s + 32] for s in range(0, len(reads), 32)]
    out = {}
    for dev in ("cuda", "cpu"):
        idx, meta, mta = load_device_index(fa, dev, verbose=False)
        tm = TorchMapper(idx, meta, mta, params, chunk_b=32, device=dev)
        recs = [[r.to_sam() for r in c] for c in tm.map_stream(iter(chunks))]
        sam = [t for t, _, _ in tm.map_stream_sam(iter(chunks))]
        assert [len(c) for c in recs] == [32, 32, 32, 4]
        assert ["".join(c) for c in recs] == sam
        out[dev] = sam
    assert out["cuda"] == out["cpu"]
    _check_records("".join(out["cuda"]), genome, 100, 97)


@pytest.mark.cuda
def test_stream_retry_runs_under_the_assembly_on_card(tmp_path):
    """The stream issues chunk c-1's overflow retry before it finishes and
    assembles chunk c-2, and waits for it a loop turn later.  50 kb reads
    at 8% substitutions pass the first pass's half band (bit 2), so every
    chunk retries; each assembly is held a few first passes long (a sleep
    in it), as the 50 kb cell's assembly outlasts a first pass.  Under
    torch.profiler, for every chunk the loop assembles, the card starts
    the next chunk's retry step inside that chunk's mapper.assemble span
    (its start event completes inside it, its end event had not at the
    span's start) and runs kernels there; every retry of the stream is
    deferred, and its SAM equals map_chunk's chunk by chunk."""
    _card()
    genome = _genome(21, 400000)
    fa = _index(tmp_path, genome, 10)
    reads = _reads(22, genome, 40, 50000, 0.08)
    chunks = [reads[s:s + 8] for s in range(0, len(reads), 8)]
    idx, meta, mta = load_device_index(fa, "cuda", verbose=False)
    tm = TorchMapper(idx, meta, mta, Params(hlen=10), chunk_b=16,
                     device="cuda")
    tm.map_chunk(chunks[0])           # builds and loads the kernels
    f0 = tm.phase_s["first_pass_device"]
    want = ["".join(r.to_sam() for r in tm.map_chunk(c)) for c in chunks]
    assert tm.retry_steps == len(chunks) + 1
    assert tm.deferred_retry_steps == 0
    pad = 3 * (tm.phase_s["first_pass_device"] - f0) / len(chunks) + 0.01

    tm = TorchMapper(idx, meta, mta, Params(hlen=10), chunk_b=16,
                     device="cuda")
    issued, seen = {}, {}
    issue, assemble = tm._issue_step, tm._assemble
    post = tm._postprocess_sam

    def issue_step(cfg, part, chunk=None):
        step = issue(cfg, part, chunk)
        issued.setdefault(chunk, []).append(step)
        return step

    def assemble_chunk(done, render):
        k = done[0].chunk
        nxt = issued.get(k + 1, [])
        ended = [r.end.query() for r in nxt]
        out = assemble(done, render)
        seen[k] = (ended, [r.start.query() for r in nxt])
        return out

    def postprocess_sam(*a, **kw):
        time.sleep(pad)
        return post(*a, **kw)

    tm._issue_step, tm._assemble = issue_step, assemble_chunk
    tm._postprocess_sam = postprocess_sam
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = [t for t, _, _ in tm.map_stream_sam(iter(chunks))]
    assert got == want
    assert tm.deferred_retry_steps == tm.retry_steps == len(chunks)
    n = len(chunks)
    # the loop assembles chunks 0..n-3 with the next chunk's retry queued
    for k in range(n - 2):
        ended, started = seen[k]
        assert started and not any(ended) and all(started), (k, seen[k])
    evs = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == "mapper.assemble"
                   and e.device_type.name == "CPU")
    kernels = [(e.time_range.start, e.time_range.end) for e in evs
               if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("mapper.", "Memcpy", "Memset"))]
    assert len(spans) == n
    for a, b in spans[:n - 2]:
        busy = sum(max(0, min(b, y) - max(a, x)) for x, y in kernels)
        print(f"[card] kernels inside an assembly span of "
              f"{(b - a) / 1e3:.4f} ms: {busy / 1e3:.4f} ms")
        assert busy > 0


# a genome of two contigs with copies of the yeast genome's high-copy
# families (benchmark/configs/yeast.json): Ty1's 32 scattered, Y' and the
# X core at contig ends
REPEATS = {"contigs": [["c1", 300000], ["c2", 200000]], "gc": 0.383,
           "repeats": [
               {"family": "Ty1", "length": 5918, "copies": 32,
                "placement": "scattered"},
               {"family": "Yprime", "length": 6700, "copies": 4,
                "placement": "telomeric"},
               {"family": "X", "length": 475, "copies": 4,
                "placement": "telomeric"}]}
TRAFFIC = {"identity": {"mean": 0.95, "max": 0.99, "stdev": 0.025},
           "errors": {"sub": 1 / 3, "ins": 1 / 3, "dele": 1 / 3},
           "reverse_share": 0.5, "pool_chunks": 2, "qual": "I"}


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi,per", [(8193, 10240, 200),
                                       (49153, 50176, 40)])
def test_stream_over_high_copy_repeats_matches_reference_on_card(
        tmp_path, monkeypatch, lo, hi, per):
    """Two chunks of ONT-like reads over REPEATS, mapped by the stream at
    chunk_b 2048 (10 kb: the resident first pass, the tiled exact tier;
    50 kb: tiled throughout): every record equals the plain reference's,
    reads take the wide vote classes and none keeps a flag.  The same
    stream with every flagged read sent to the exact tier (the classes
    off) takes at most the class steps' vote scratch less device memory
    above what was allocated before it."""
    _card()
    from benchmark.judge import judge
    from benchmark.reference import Reference
    from benchmark.run import build_mapper
    from benchmark.traffic import make_genome, make_pool, write_fasta
    from longreadmapper_tpu_torch import native_build
    from longreadmapper_tpu_torch.models import mapper as tmapper
    from longreadmapper_tpu_torch.ops.vote import VOTE_FUNCS, pow2_at_least
    g = make_genome(REPEATS, 23)
    pool = make_pool(g, dict(TRAFFIC, chunk_reads=per, lengths=dict(
        mean=15000, stdev=13000, min=lo, max=hi)), 23, "cuda")
    fa = str(tmp_path / "rep.fa")
    write_fasta(fa, g)
    tm = build_mapper(dict(mapper=dict(seed_len=20, thres=300, hlen=12,
                                       chunk_b=2048)), fa, "cuda")
    tm.warmup([hi])
    chunks = [[(f"r{i}", pool.seqs[i], pool.quals[i]) for i in
               pool.chunk(k)] for k in range(pool.n_chunks)]
    issued = []
    issue = tm._issue_step

    def issue_step(cfg, part, chunk=None):
        issued.append(cfg)
        return issue(cfg, part, chunk)

    tm._issue_step = issue_step

    def above_base(run):
        """run()'s result and the device memory it took at its peak above
        what was allocated before it (earlier tests' garbage collected)."""
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        return out, torch.cuda.max_memory_allocated() - base

    text, peak = above_base(lambda: "".join(
        t for t, _, _ in tm.map_stream_sam(iter(chunks))))
    assert tm.wide_vote_reads > 0 and tm.wide_vote_steps > 0
    assert tm.wide_vote_unresolved == tm.overflow_reads == 0
    rows = [line.split("\t") for line in text.splitlines()]
    reads = [(n, s) for c in chunks for n, s, _ in c]
    ref = Reference(g, 20, 300, "cuda")
    counts = judge(rows, reads, ref.map_reads([s for _, s in reads]), ref)
    assert counts["records_wrong"] == 0, counts["wrong"][:8]

    lib = native_build.load("vote", VOTE_FUNCS)
    exact = tm._retry_step_for(tm._step_for(hi).L).vote_slots
    scratch = max(c.B * c.phases * lib.lrm_vote_scratch_bytes(
        pow2_at_least(c.vote_slots), c.max_seeds, int(c.pos64))
        for c in issued if c.vote_slots > exact)
    monkeypatch.setattr(tmapper, "vote_classes",
                        lambda need, slots: np.zeros(len(need), np.int64))
    _, peak_exact = above_base(lambda: list(tm.map_stream_sam(iter(chunks))))
    print(f"[card] {hi}: peak {peak} B with the classes, {peak_exact} B "
          f"without, class scratch {scratch} B")
    assert peak <= peak_exact + scratch


# a contig with a tandem array of 320 identical 500 bp copies (160 kb):
# every seed inside it passes thres on each strand, as over DXZ1
# (benchmark/configs/human_chrX.json), and a 100 kb read fits inside it
ARRAY = {"contigs": [["c1", 700000]], "gc": 0.395,
         "repeats": [{"family": "sat", "length": 500, "copies": 320,
                      "placement": "tandem", "contig": "c1", "at": 250000}]}


@pytest.mark.cuda
def test_stream_of_100kb_reads_over_a_tandem_array_matches_reference_on_card(
        tmp_path):
    """16 reads of 98,305-100,352 bases (the 100,352 bucket, B 16), some
    over or inside ARRAY, through map_stream_sam at chunk_b 2048 with no
    option: every record equals the plain reference's and every mapped
    CIGAR spells its ED against the genome; the reads past the first
    pass's half band take the full-band retry, whose gact steps keep int32
    run entries."""
    _card()
    from benchmark.judge import judge
    from benchmark.reference import Reference
    from benchmark.run import build_mapper
    from benchmark.traffic import make_genome, make_pool, write_fasta
    g = make_genome(ARRAY, 31)
    pool = make_pool(g, dict(TRAFFIC, chunk_reads=16, pool_chunks=1,
                             lengths=dict(mean=15000, stdev=13000,
                                          min=98305, max=100352)), 31,
                     "cuda")
    fa = str(tmp_path / "array.fa")
    write_fasta(fa, g)
    tm = build_mapper(dict(mapper=dict(seed_len=20, thres=300, hlen=12,
                                       chunk_b=2048)), fa, "cuda")
    tm.warmup([100352])
    chunk = [(f"r{i}", pool.seqs[i], pool.quals[i]) for i in pool.chunk(0)]
    text = "".join(t for t, _, _ in tm.map_stream_sam(iter([chunk])))
    rows = [line.split("\t") for line in text.splitlines()]
    reads = [(n, s) for n, s, _ in chunk]
    ref = Reference(g, 20, 300, "cuda")
    counts = judge(rows, reads, ref.map_reads([s for _, s in reads]), ref)
    assert counts["records_wrong"] == 0, counts["wrong"][:8]
    genome = "".join("ACGT"[c] for c in g.codes)
    _check_records(text, genome, 16, 8)
    lo, hi = 250000, 250000 + 320 * 500
    over = [i for i in pool.chunk(0)
            if pool.origin[i] < hi and pool.origin[i] + pool.lengths[i] > lo]
    print(f"[card] 100 kb: {len(over)} reads over the array, retried "
          f"{tm.retried_reads}, gact steps {tm.gact_steps} "
          f"({tm.int32_gact_steps} int32), overflow reads "
          f"{tm.overflow_reads}")
    assert over and tm.retried_reads > 0
    assert tm.gact_steps > tm.int32_gact_steps > 0
