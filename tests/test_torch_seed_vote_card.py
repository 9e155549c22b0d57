"""The seed vote's CUDA kernels (csrc/vote.cu) on the card against their
plain versions (ops/seed_vote.py, ops/vote.py), bit for bit: the tables,
and the vote with its accept ((best, overflow) and every row's v1, key1,
v2, total and wide-drop flag against vote_accept_plain) in the full, slim
and split-hi pos64 layouts, with left == 0, wide seeds (narrowed in the
kernel, more than the lanes in a budget that drops some), rows with no
vote and rows past C, the exact tier, rows of C 20096 that pass shared
memory and sort in global scratch, tables that stand for a row-sharded
index (two launches each, the rows gathered between them), and C on both
sides of the warp / CTA boundary (Cpad 32 to 4096; the CTA rows' accept
by the read's last CTA, twice in a row, its counters back at 0);
top2_votes on int32 and int64 keys, rows of 120,000 votes in global
scratch among them; the wide vote classes at 10 kb, rows of 2,048 to the
exact tier's widest 262,144 slots, on reads inside a 290-copy tandem
repeat whose rows hold ~140,000 votes; and the mapping step with no host sync, under
torch.cuda.set_sync_debug_mode("error"); and seed_tables_kernel's CTA split
at the long buckets' shapes (whole phase rows or slices of one a CTA) in
every layout and both stages, codes outside 0-4 among them.

Card-only: the tests skip where torch.cuda.is_available() is false, and
import no JAX, so they run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_seed_vote_card.py
"""

from dataclasses import dataclass, replace

import numpy as np
import pytest
import torch

from longreadmapper_tpu_torch.index.device import load_device_index
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.ops import vote as tvote
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.utils.config import Params

torch.set_num_threads(1)
HLEN = 6


@dataclass(frozen=True)
class _Slots(tpipe.MapperConfig):
    """A config whose vote rows have `slots` slots (0: the tier's own)."""
    slots: int = 0

    @property
    def vote_slots(self) -> int:
        return self.slots or super().vote_slots


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


class _Rows:
    """A table that is not a tensor, gathered by indexing, as a
    ShardedRows block is (parallel/dist.py) but on one device: it sends
    the kernels down their two-launch path."""

    def __init__(self, t):
        self.t, self.shape, self.dtype = t, t.shape, t.dtype

    def __getitem__(self, i):
        return self.t[i]


@pytest.fixture(scope="module")
def genome_fa(tmp_path_factory):
    """A 16 kb random genome with a 40x 60-mer tandem repeat in its
    middle, indexed at hlen 6 by the port."""
    rng = np.random.default_rng(5)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    genome = rand(8000) + rand(60) * 40 + rand(8000)
    fa = str(tmp_path_factory.mktemp("seed_vote_card") / "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + genome + "\n")
    build_index(fa, Params(hlen=HLEN), verbose=False, device=None)
    return fa, genome


def _reads(genome, n=24, L=200):
    """Reads at 3% from the whole genome, a third inside the repeat, one
    with an N run, one shorter than the seed."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        p = (int(rng.integers(7900, 10200)) if i % 3 == 0
             else int(rng.integers(0, len(genome) - L)))
        s = np.frombuffer(genome[p:p + L].encode(), np.uint8).copy()
        m = rng.random(L) < 0.03
        s[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                             int(m.sum()))]
        out.append((f"r{i}", s.tobytes().decode(), None))
    out[1] = ("n", out[1][1][:50] + "N" * 20 + out[1][1][70:], None)
    out[2] = ("short", out[2][1][:12], None)
    return out


def _inputs(fa, genome, dev, load, params, B=32, L=256, **kw):
    idx, meta, mta = load_device_index(fa, dev, verbose=False, **load)
    cfg = _Slots(**vars(replace(
        tpipe.MapperConfig.from_params(params, meta, B, L),
        **{k: v for k, v in kw.items() if k != "slots"})),
        slots=kw.get("slots", 0))
    tm = TorchMapper(idx, meta, mta, params, chunk_b=B, device=dev)
    codes, _, lens, _ = tm._pack_reads(_reads(genome), L, B)
    return (idx, cfg, torch.from_numpy(codes).to(dev),
            torch.from_numpy(lens).to(dev))


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _equal(g, w)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _vote_twice(cfg, idx, lens, tabs):
    """The vote kernel twice in a row against vote_accept_plain; the
    read counters stay at 0.  Returns the plain (best, overflow, rows)."""
    rank = tsv.wide_rank(tabs[3])
    want = tsv.vote_accept_plain(cfg, idx, lens, tabs, rank)
    for _ in range(2):
        _equal(tsv.vote_rows(cfg, idx, lens, tabs, rank), want)
    assert not tsv._TICKETS[lens.device].any()
    return want


LAYOUTS = [dict(), dict(slim=True), dict(force_pos_dtype="int64"),
           dict(force_pos_dtype="int64", slim=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("load", LAYOUTS)
@pytest.mark.parametrize("case", ["plain", "left0", "wide", "budget",
                                  "exact", "sharded", "huge"])
def test_seed_vote_kernels_match_plain_on_card(genome_fa, load, case):
    _card()
    fa, genome = genome_fa
    params = Params(hlen=HLEN, seed_len=HLEN if case == "left0" else 20,
                    thres=30 if case in ("wide", "budget") else 300)
    kw = dict(wide_budget=4) if case == "budget" else {}
    if case in ("exact", "huge"):
        kw["exact_slots"] = True
    if case == "huge":        # C = 20096: past shared memory, global rows
        kw["vote_budget"] = 20000
    idx, cfg, codes, lens = _inputs(fa, genome, "cuda", load, params, **kw)
    if case == "sharded":
        for k in ("lch", "lch_hi", "sa_ctx", "sa_hi", "text_pair"):
            if getattr(idx, k) is not None:
                setattr(idx, k, _Rows(getattr(idx, k)))
    n = (tsv.seed_tables.launches, tsv.vote_rows.launches)
    tabs = tsv.seed_tables(cfg, idx, codes, lens)
    want = tsv.seed_tables_plain(cfg, idx, codes, lens)
    _equal(tabs, want)
    if case in ("wide", "budget"):
        assert want[3].any()
    best, overflow, rows = _vote_twice(cfg, idx, lens, want)
    per = 2 if case == "sharded" else 1
    assert (tsv.seed_tables.launches, tsv.vote_rows.launches) == (
        n[0] + per, n[1] + 2 * per)
    if case == "plain":
        assert (rows[3] > cfg.vote_slots).any()       # the repeat's rows
        assert (rows[3] == 0).any()                   # the short read's
    if case == "budget":
        assert rows[4].any() and overflow.any()       # dropped wide seeds
    assert (rows[0] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("load", LAYOUTS)
@pytest.mark.parametrize("L,sharded", [(4000, False), (22000, False),
                                       (22000, True), (1029, True)])
def test_seed_tables_kernel_at_long_buckets_on_card(genome_fa, load, L,
                                                    sharded):
    """seed_tables_kernel's CTA split past one CTA a read: a few phase
    rows a CTA (L 4000; L 1029, not a multiple of 16, with a row-sharded
    index's two stages), slices of one row (L 22000, S > 1024); reads from
    the genome with N runs, ragged ends, one of arbitrary int8 codes;
    thres 3 makes many seeds wide."""
    _card()
    fa, genome = genome_fa
    idx, meta, _ = load_device_index(fa, "cuda", verbose=False, **load)
    cfg = tpipe.MapperConfig.from_params(Params(hlen=HLEN, thres=3), meta,
                                         4, L)
    rng = np.random.default_rng(L)
    lut = np.full(256, 4, np.int8)
    lut[list(b"ACGT")] = [0, 1, 2, 3]
    g = lut[np.frombuffer(genome.encode(), np.uint8)]
    codes = np.full((4, L), 4, np.int8)
    lens = np.zeros(4, np.int32)
    for b in range(4):
        n = L if b == 3 else int(rng.integers(L // 2, L))
        p = int(rng.integers(0, len(g) - min(n, len(g)) + 1))
        seg = g[p:p + n]
        codes[b, :len(seg)] = seg
        codes[b, len(seg):n] = rng.integers(0, 4, n - len(seg))
        s = int(rng.integers(0, n - 40))
        codes[b, s:s + 30] = 4
        lens[b] = n
    codes[1] = rng.integers(-128, 128, L)
    codes, lens = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
    if sharded:
        for k in ("lch", "lch_hi"):
            if getattr(idx, k) is not None:
                setattr(idx, k, _Rows(getattr(idx, k)))
    n0 = tsv.seed_tables.launches
    want = tsv.seed_tables_plain(cfg, idx, codes, lens)
    _equal(tsv.seed_tables(cfg, idx, codes, lens), want)
    assert tsv.seed_tables.launches == n0 + (2 if sharded else 1)
    assert want[3].any() and (want[5] > 0).any()
    assert (cfg.max_seeds >= 1024) == (L == 22000)


@pytest.mark.cuda
@pytest.mark.parametrize("load", [dict(), dict(force_pos_dtype="int64"),
                                  dict(slim=True)])
@pytest.mark.parametrize("slots", [20, 64, 500, 512, 513, 1000, 4000])
def test_vote_kernels_at_each_row_size_on_card(genome_fa, load, slots):
    """C from Cpad 32 to 4096: at most 512 a warp a row (vote_warp_kernel),
    above it a CTA a row (vote_cta_kernel) whose read's last CTA runs the
    accept, twice in a row."""
    _card()
    fa, genome = genome_fa
    params = Params(hlen=HLEN, thres=300)
    idx, cfg, codes, lens = _inputs(fa, genome, "cuda", load, params,
                                    slots=slots)
    assert cfg.vote_slots == slots
    tabs = tsv.seed_tables_plain(cfg, idx, codes, lens)
    best, overflow, rows = _vote_twice(cfg, idx, lens, tabs)
    assert (rows[0] > 0).any() and (best != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,spread", [(torch.int32, 1000),
                                          (torch.int32, 1 << 28),
                                          (torch.int64, 1 << 40)])
@pytest.mark.parametrize("B,V", [(64, 80), (7, 1), (33, 600), (5, 4864),
                                 (3, 120000),     # past shared memory
                                 (40, 32), (9, 512), (9, 513)])
def test_top2_votes_kernel_matches_plain_on_card(dtype, spread, B, V):
    _card()
    rng = np.random.default_rng(B + V)
    base = rng.integers(-spread // 2, spread, (B, 1))
    keys = torch.from_numpy(base + rng.integers(-48, 48, (B, V))).to(dtype)
    valid = torch.from_numpy(rng.random((B, V)) < 0.7)
    valid[0] = False
    keys[-1] = -5
    keys, valid = keys.cuda(), valid.cuda()
    n = tvote.top2_votes.launches
    got = tvote.top2_votes(keys, valid)
    assert tvote.top2_votes.launches == n + 1
    _equal(got, tvote.top2_votes_plain(keys, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("load", [dict(), dict(slim=True)])
def test_map_step_makes_no_host_sync_on_card(genome_fa, load):
    """The whole step under set_sync_debug_mode("error"): no op of it
    waits for the card; the bytes equal the step's on the CPU."""
    _card()
    fa, genome = genome_fa
    params = Params(hlen=HLEN, thres=30)            # wide seeds included
    out = {}
    for dev in ("cpu", "cuda"):
        idx, meta, mta = load_device_index(fa, dev, verbose=False, **load)
        tm = TorchMapper(idx, meta, mta, params, chunk_b=32, device=dev)
        cfg = tm._step_for(256)
        arrays = [torch.from_numpy(a).to(dev)
                  for a in tm._pack_reads(_reads(genome), 256, 32)]
        if dev == "cuda":
            tpipe.map_step(cfg, idx, *arrays)         # builds, warms up
            torch.cuda.synchronize()
            plain = (tsv.seed_tables_plain.cuda_calls,
                     tsv.vote_rows_plain.cuda_calls,
                     tsv.seed_accept_plain.cuda_calls)
            torch.cuda.set_sync_debug_mode("error")
            try:
                step = tpipe.map_step(cfg, idx, *arrays)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert (tsv.seed_tables_plain.cuda_calls,
                    tsv.vote_rows_plain.cuda_calls,
                    tsv.seed_accept_plain.cuda_calls) == plain
        else:
            step = tpipe.map_step(cfg, idx, *arrays)
        out[dev] = {k: v.cpu() for k, v in step.items()}
    for k in ("blob", "ops_tail"):
        assert torch.equal(out["cuda"][k], out["cpu"][k])


@pytest.fixture(scope="module")
def tandem_fa(tmp_path_factory):
    """A 33 kb genome: a 60-mer 290 times in tandem between random flanks,
    indexed at hlen 6: a 10 kb read inside it has ~290 occurrences of
    every seed, just under thres."""
    rng = np.random.default_rng(9)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    genome = rand(8000) + rand(60) * 290 + rand(8000)
    fa = str(tmp_path_factory.mktemp("wide_classes_card") / "t.fa")
    with open(fa, "w") as f:
        f.write(">t\n" + genome + "\n")
    build_index(fa, Params(hlen=HLEN), verbose=False, device=None)
    return fa, genome


@pytest.mark.cuda
@pytest.mark.parametrize("load", [dict(), dict(force_pos_dtype="int64")])
@pytest.mark.parametrize("slots", [32768, 65536, 262144])
def test_vote_kernels_at_wide_classes_on_card(tandem_fa, load, slots):
    """The vote kernels against vote_accept_plain at the wide vote classes
    the mapper makes at the 10 kb bucket on this genome (past its exact
    tier's 16,512 slots), up to the widest (vote_slots_max, 262,144), on
    the mapper's class step config: four reads, two inside the tandem
    repeat (rows of over 100,000 votes), two across its edges; the pick
    keeps every wide seed, so a row holds what vote_need counts; twice in
    a row."""
    _card()
    fa, genome = tandem_fa
    L = 10240
    idx, meta, mta = load_device_index(fa, "cuda", verbose=False, **load)
    params = Params(hlen=HLEN, thres=300)
    reads = [(f"r{i}", genome[p:p + L - 40], None)
             for i, p in enumerate((9000, 13000, 2000, 22400))]
    tm = TorchMapper(idx, meta, mta, params, chunk_b=4, device="cuda")
    cfg = tm._wide_step_for(L, slots, 4)
    assert cfg.vote_slots_max == 262144
    assert (cfg.B, cfg.vote_slots) == (4, slots)
    assert tm._retry_step_for(L).vote_slots < 32768
    codes, _, lens, _ = tm._pack_reads(reads, L, 4)
    codes = torch.from_numpy(codes).cuda()
    lens = torch.from_numpy(lens).cuda()
    tabs = tsv.seed_tables(cfg, idx, codes, lens)
    _equal(tabs, tsv.seed_tables_plain(cfg, idx, codes, lens))
    best, overflow, rows = _vote_twice(cfg, idx, lens, tabs)
    need = tsv.vote_need(cfg, tabs)
    assert int(need.max()) > 100000
    assert torch.equal(rows[3].reshape(4, -1).amax(1), need)
    # a read whose widest row fits its class keeps no bit 0
    assert not overflow[need <= slots].any()
    assert overflow.any() == (slots < cfg.vote_slots_max)
    assert not rows[4].any()
    assert (rows[0] > 0).all()
