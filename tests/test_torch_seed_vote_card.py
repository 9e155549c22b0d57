"""The seed vote's CUDA kernels (csrc/vote.cu) on the card against their
plain versions (ops/seed_vote.py, ops/vote.py), bit for bit: the tables
and vote rows in the full, slim and split-hi pos64 layouts, with
left == 0, wide seeds (narrowed in the kernel, some dropped by a lane
budget), rows past C, the exact tier, rows of C 20096 that pass shared
memory and sort in global scratch, and tables that stand for a
row-sharded index (two launches each, the rows gathered between them);
top2_votes on int32 and int64 keys, rows of 120,000 votes in global
scratch among them; and the mapping step with no host sync, under
torch.cuda.set_sync_debug_mode("error").

Card-only: the tests skip where torch.cuda.is_available() is false, and
import no JAX, so they run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_seed_vote_card.py
"""

from dataclasses import replace

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
    cfg = replace(tpipe.MapperConfig.from_params(params, meta, B, L), **kw)
    tm = TorchMapper(idx, meta, mta, params, chunk_b=B, device=dev)
    codes, _, lens, _ = tm._pack_reads(_reads(genome), L, B)
    return (idx, cfg, torch.from_numpy(codes).to(dev),
            torch.from_numpy(lens).to(dev))


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


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
    qw, k12, cnt12, wide, kw_, cw = want
    if case in ("wide", "budget"):
        assert wide.any()
    k_seed, cnt, _ = tpipe._pick_wide_seeds(cfg, wide, k12, cnt12, kw_, cw)
    rows = tsv.vote_rows(cfg, idx, k_seed, cnt, qw, wide)
    want = tsv.vote_rows_plain(cfg, idx, k_seed, cnt, qw, wide)
    _equal(rows, want)
    per = 2 if case == "sharded" else 1
    assert (tsv.seed_tables.launches, tsv.vote_rows.launches) == (
        n[0] + per, n[1] + per)
    if case == "plain":
        assert (want[3] > cfg.vote_slots).any()       # the repeat's rows
    assert (want[0] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,spread", [(torch.int32, 1000),
                                          (torch.int32, 1 << 28),
                                          (torch.int64, 1 << 40)])
@pytest.mark.parametrize("B,V", [(64, 80), (7, 1), (33, 600), (5, 4864),
                                 (3, 120000)])    # past shared memory
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
                     tsv.vote_rows_plain.cuda_calls)
            torch.cuda.set_sync_debug_mode("error")
            try:
                step = tpipe.map_step(cfg, idx, *arrays)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert (tsv.seed_tables_plain.cuda_calls,
                    tsv.vote_rows_plain.cuda_calls) == plain
        else:
            step = tpipe.map_step(cfg, idx, *arrays)
        out[dev] = {k: v.cpu() for k, v in step.items()}
    for k in ("blob", "ops_tail"):
        assert torch.equal(out["cuda"][k], out["cpu"][k])
