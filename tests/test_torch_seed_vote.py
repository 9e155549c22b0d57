"""The seed vote's plain versions (ops/seed_vote.py: seed_tables_plain,
vote_rows_plain; mapping/pipeline._pick_wide_seeds) against the JAX
step's intermediates on the same chunk.

JAX's _seed_vote runs eagerly with its _narrow_wide_seeds and top2_votes
wrapped, so the test reads their inputs (the per-seed tables qw, k12,
cnt12, wide), their outputs (k_seed, cnt, the rows that lost a wide
seed; each row's v1, key1, v2) and JAX's row totals (the cumsum of cnt).
Cases: the full and slim layouts, the split-hi pos64 layouts (JAX in x64
mode in a subprocess), left == 0 (seed_len == hlen), wide seeds on a
tandem repeat (LF-narrowed) with and without a lane budget that drops
some, rows past C on the repeat, and the exact tier.  Every comparison is
exact.  The wrappers' dispatch on a CPU tensor reaches the plain versions
(the kernels: tests/test_torch_seed_vote_card.py)."""

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import sample_reads
from _torch_parity import e2e_fixture, repeat_fixture
from longreadmapper_tpu.index import device as jdevice
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.index import device as tdevice
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.ops import vote as tvote

torch.set_num_threads(1)
HLEN = 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    return e2e_fixture(tmp_path_factory.mktemp("torch_seed_vote"))


@pytest.fixture(scope="module")
def rep(tmp_path_factory):
    return repeat_fixture(tmp_path_factory.mktemp("torch_seed_vote_rep"))


def jax_intermediates(jc, jidx, codes, lens):
    """JAX's _seed_vote on one chunk, eagerly, with its wide-seed narrowing
    and top-2 wrapped: the per-seed tables, the narrowing's outputs, each
    row's top-2 and total, and (best, overflow)."""
    got = {}
    narrow, top2 = jpipe._narrow_wide_seeds, jpipe.top2_votes

    def narrow_spy(cfg, idx, wide, k12, l12, cnt12, qw):
        out = narrow(cfg, idx, wide, k12, l12, cnt12, qw)
        got.update(wide=wide, k12=k12, cnt12=cnt12, qw=qw, k_seed=out[0],
                   cnt=out[1], row_overflow=out[2],
                   total=jnp.cumsum(out[1], axis=1)[:, -1])
        return out

    def top2_spy(keys, valid):
        out = top2(keys, valid)
        got.update(v1=out[0], key1=out[1], v2=out[2])
        return out

    jpipe._narrow_wide_seeds, jpipe.top2_votes = narrow_spy, top2_spy
    try:
        best, overflow = jpipe._seed_vote(jc, jidx, jnp.asarray(codes),
                                          jnp.asarray(lens))
    finally:
        jpipe._narrow_wide_seeds, jpipe.top2_votes = narrow, top2
    got.update(best=best, overflow=overflow)
    return {k: np.asarray(v) for k, v in got.items()}


def port_intermediates(tc, tidx, codes, lens):
    """The same quantities from the port's plain versions."""
    codes, lens = torch.from_numpy(codes), torch.from_numpy(lens)
    qw, k12, cnt12, wide, kw, cw = tsv.seed_tables_plain(tc, tidx, codes,
                                                         lens)
    k_seed, cnt, row_overflow = tpipe._pick_wide_seeds(tc, wide, k12, cnt12,
                                                       kw, cw)
    v1, key1, v2, total = tsv.vote_rows_plain(tc, tidx, k_seed, cnt, qw,
                                              wide)
    best, overflow = tpipe._seed_vote(tc, tidx, codes, lens)
    return {k: v.numpy() for k, v in dict(
        qw=qw, k12=k12, cnt12=cnt12, wide=wide, k_seed=k_seed, cnt=cnt,
        row_overflow=row_overflow, v1=v1, key1=key1, v2=v2, total=total,
        best=best, overflow=overflow).items()}


def _chunk(d, params, reads, B, L, tidx, tmeta):
    tm = TorchMapper(tidx, tmeta, d["mta"], params, chunk_b=B, device="cpu")
    codes, _, lens, _ = tm._pack_reads(reads, L, B)
    return codes, lens


def _compare(want, got):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _both(d, params, reads, B=16, L=256, slim=False, **kw):
    args = (d["fmi"], d["kl"], HLEN, d["cat"], d["mta"])
    jidx, jmeta = (jdevice.build_device_index(*args, slim=True) if slim
                   else (d["idx"], d["meta"]))
    tidx, tmeta = (tdevice.build_device_index(*args, "cpu", slim=True)
                   if slim else (d["tidx"], d["tmeta"]))
    jc = replace(jpipe.MapperConfig.from_params(params, jmeta, B, L), **kw)
    tc = replace(tpipe.MapperConfig.from_params(params, tmeta, B, L), **kw)
    codes, lens = _chunk(d, params, reads, B, L, tidx, tmeta)
    want = jax_intermediates(jc, jidx, codes, lens)
    got = port_intermediates(tc, tidx, codes, lens)
    _compare(want, got)
    return tc, got


def _e2e_reads(d, n=12):
    rng = np.random.default_rng(31)
    reads = sample_reads(rng, d["chrA"], n, 200, error_rate=0.03)
    reads = [(nm, s, None) for nm, s, *_ in reads]
    s = np.frombuffer(reads[0][1].encode(), np.uint8).copy()
    s[rng.integers(0, len(s), 6)] = ord("N")
    reads[0] = (reads[0][0], s.tobytes().decode(), None)
    return reads + [("short", d["chrB"][100:115], None)]


@pytest.mark.parametrize("slim", [False, True])
@pytest.mark.parametrize("seed_len", [20, HLEN])      # HLEN: left == 0
def test_plain_seed_vote_matches_jax_layouts(e2e, slim, seed_len):
    tc, got = _both(e2e, Params(hlen=HLEN, seed_len=seed_len, thres=300),
                    _e2e_reads(e2e), slim=slim)
    assert tc.left == seed_len - HLEN
    assert (got["v1"] > 0).sum() > got["v1"].shape[0] // 4
    assert not got["wide"].any()


def test_plain_seed_vote_matches_jax_exact_tier(e2e):
    tc, got = _both(e2e, Params(hlen=HLEN, seed_len=20, thres=300),
                    _e2e_reads(e2e), exact_slots=True)
    assert tc.vote_slots == tc.vote_slots_exact > 64


@pytest.mark.parametrize("wide_budget", [0, 4])
def test_plain_seed_vote_matches_jax_wide_seeds(rep, wide_budget):
    """The repeat's seeds are wide (LF-narrowed); a 4-lane budget drops
    some, whose rows flag overflow."""
    tc, got = _both(rep, Params(hlen=HLEN, thres=30), rep["reads"], B=8,
                    wide_budget=wide_budget)
    assert got["wide"].any()
    assert got["row_overflow"].any() == (wide_budget == 4)


@pytest.mark.parametrize("exact", [False, True])
def test_plain_seed_vote_matches_jax_rows_past_c(rep, exact):
    """Below thres the repeat's seeds are not wide but vote ~40 times
    each: their rows pass C in the compact tier (the overflow of bit 0),
    and in the exact tier too (the mapper's exact tier is sized for the
    genome's background, not for a repeat)."""
    tc, got = _both(rep, Params(hlen=HLEN, thres=300), rep["reads"], B=8,
                    exact_slots=exact)
    assert not got["wide"].any()
    if not exact:
        assert (got["total"] > tc.vote_slots).any() and got["overflow"].any()


def test_pick_without_wide_seeds_is_the_no_wide_branch(e2e):
    """With no wide seed the always-run pick returns JAX's other branch
    bit for bit: k12, cnt12 and no row overflow (ROADMAP.md B3.4)."""
    params = Params(hlen=HLEN, seed_len=20, thres=300)
    tc = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 16, 256)
    codes, lens = _chunk(e2e, params, _e2e_reads(e2e), 16, 256, e2e["tidx"],
                         e2e["tmeta"])
    qw, k12, cnt12, wide, kw, cw = tsv.seed_tables_plain(
        tc, e2e["tidx"], torch.from_numpy(codes), torch.from_numpy(lens))
    assert not wide.any()
    k_seed, cnt, ovf = tpipe._pick_wide_seeds(tc, wide, k12, cnt12, kw, cw)
    assert k_seed.dtype == k12.dtype and torch.equal(k_seed, k12)
    assert cnt.dtype == torch.int32 and torch.equal(cnt, cnt12)
    assert ovf.dtype == torch.bool and not ovf.any()
    assert ovf.shape == (wide.shape[0],)


def test_pick_keeps_the_first_wide_lanes_in_flat_order():
    """The rank picks the first wide_lanes wide seeds in flat order, as
    JAX's stable sort of the wide flags does, and no more than there
    are lanes."""
    cfg = replace(tpipe.MapperConfig(B=2, L=64, seed_len=20, gap_len=1,
                                     thres=30, hlen=6, n=1000, dollar_pos=3,
                                     accept_score=0.6, error_rate=0.1),
                  wide_budget=3)
    wide = torch.tensor([[0, 1, 0, 1], [1, 0, 1, 1]], dtype=torch.bool)
    k12 = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    cnt12 = torch.full((2, 4), 30, dtype=torch.int32)
    kw, cw = k12 + 100, torch.full((2, 4), 7, dtype=torch.int32)
    k_seed, cnt, ovf = tpipe._pick_wide_seeds(cfg, wide, k12, cnt12, kw, cw)
    assert k_seed.tolist() == [[0, 101, 2, 103], [104, 5, 6, 7]]
    assert cnt.tolist() == [[30, 7, 30, 7], [7, 30, 0, 0]]
    assert ovf.tolist() == [False, True]
    cfg = replace(cfg, wide_budget=100)         # more lanes than seeds
    assert not tpipe._pick_wide_seeds(cfg, wide, k12, cnt12, kw,
                                      cw)[2].any()


def test_wrappers_take_the_plain_versions_on_cpu(e2e):
    """CPU tensors reach the plain versions: no launch, no plain call
    counted on the card, results equal."""
    params = Params(hlen=HLEN, seed_len=20, thres=300)
    tc = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 16, 256)
    codes, lens = (torch.from_numpy(a) for a in _chunk(
        e2e, params, _e2e_reads(e2e), 16, 256, e2e["tidx"], e2e["tmeta"]))
    counts = (tsv.seed_tables.launches, tsv.vote_rows.launches,
              tvote.top2_votes.launches, tsv.seed_tables_plain.cuda_calls,
              tsv.vote_rows_plain.cuda_calls,
              tvote.top2_votes_plain.cuda_calls)
    tabs = tsv.seed_tables(tc, e2e["tidx"], codes, lens)
    for g, w in zip(tabs, tsv.seed_tables_plain(tc, e2e["tidx"], codes,
                                                lens)):
        assert torch.equal(g, w)
    qw, k12, cnt12, wide, kw, cw = tabs
    rows = tsv.vote_rows(tc, e2e["tidx"], k12, cnt12, qw, wide)
    for g, w in zip(rows, tsv.vote_rows_plain(tc, e2e["tidx"], k12, cnt12,
                                              qw, wide)):
        assert torch.equal(g, w)
    keys = torch.arange(-40, 40, dtype=torch.int32).reshape(4, 20)
    valid = keys % 3 != 0
    for g, w in zip(tvote.top2_votes(keys, valid),
                    tvote.top2_votes_plain(keys, valid)):
        assert torch.equal(g, w)
    assert (tsv.seed_tables.launches, tsv.vote_rows.launches,
            tvote.top2_votes.launches, tsv.seed_tables_plain.cuda_calls,
            tsv.vote_rows_plain.cuda_calls,
            tvote.top2_votes_plain.cuda_calls) == counts


def test_seed_vote_marks_its_stages(e2e):
    params = Params(hlen=HLEN, seed_len=20, thres=300)
    tc = tpipe.MapperConfig.from_params(params, e2e["tmeta"], 16, 256)
    codes, lens = (torch.from_numpy(a) for a in _chunk(
        e2e, params, _e2e_reads(e2e), 16, 256, e2e["tidx"], e2e["tmeta"]))
    marks = []
    got = tpipe._seed_vote(tc, e2e["tidx"], codes, lens, marks.append)
    want = tpipe._seed_vote(tc, e2e["tidx"], codes, lens)
    assert marks == ["seed_tables", "narrow", "vote_rows", "accept"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# JAX in x64 mode (forced pos64 layouts) runs in a process of its own
POS64_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json
import numpy as np
from dataclasses import replace
from longreadmapper_tpu.index.device import load_device_index
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.utils.config import Params
from test_torch_seed_vote import jax_intermediates
fa, npz, out, cfg_json = sys.argv[2:6]
kw = json.loads(cfg_json)
slim = kw.pop("slim")
idx, meta, _ = load_device_index(fa, force_pos_dtype="int64", slim=slim)
assert meta.pos_dtype == "int64" and meta.slim == slim
params = Params(**kw.pop("params"))
B, L = kw.pop("B"), kw.pop("L")
jc = replace(jpipe.MapperConfig.from_params(params, meta, B, L), **kw)
d = np.load(npz)
np.savez(out, **jax_intermediates(jc, idx, d["codes"], d["lens"]))
"""


@pytest.mark.parametrize("case", ["full", "slim", "wide"])
def test_plain_seed_vote_matches_jax_pos64(e2e, rep, tmp_path, case):
    """The split-hi pos64 layouts (forced on the small genome): int64 k12,
    k_seed and key1 from the joined high bytes, against JAX in x64 mode;
    they equal the int32 layout's values widened."""
    d = rep if case == "wide" else e2e
    slim = case == "slim"
    pkw = (dict(hlen=HLEN, thres=30) if case == "wide"
           else dict(hlen=HLEN, seed_len=20, thres=300))
    params = Params(**pkw)
    reads = rep["reads"] if case == "wide" else _e2e_reads(e2e)
    B, L = (8 if case == "wide" else 16), 256
    args = (d["fmi"], d["kl"], HLEN, d["cat"], d["mta"])
    tidx, tmeta = tdevice.build_device_index(*args, "cpu",
                                             force_pos_dtype="int64",
                                             slim=slim)
    tc = tpipe.MapperConfig.from_params(params, tmeta, B, L)
    assert tc.pos64 and tc.slim == slim
    codes, lens = _chunk(d, params, reads, B, L, tidx, tmeta)
    np.savez(tmp_path / "in.npz", codes=codes, lens=lens)
    cfg = dict(slim=slim, params=pkw, B=B, L=L)
    r = subprocess.run([sys.executable, "-c", POS64_WORKER, ROOT, d["fa"],
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz"),
                        json.dumps(cfg)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    got = port_intermediates(tc, tidx, codes, lens)
    assert got["k12"].dtype == got["key1"].dtype == np.int64
    _compare(want, got)
    tc32 = tpipe.MapperConfig.from_params(params, d["tmeta"], B, L)
    if not slim:
        narrow = port_intermediates(tc32, d["tidx"], codes, lens)
        for k in ("k12", "k_seed", "key1", "v1", "v2", "total"):
            np.testing.assert_array_equal(got[k], narrow[k], err_msg=k)
