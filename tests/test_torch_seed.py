"""Seeding of the port against the JAX package on shared indexes: FM rank
(ops/rank.occ, backward_step), the seed-vote stage
mapping/pipeline._seed_vote -> (best, overflow), and ops/step._seq_lookup.  Inputs
come from the tests/test_e2e.py genome (reads with injected Ns) and from a
tandem-repeat genome whose seeds are wide (hits >= thres), which takes the
LF-narrowing branch; a tiny wide-lane budget forces its lane overflow.
Exact equality throughout."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import sample_reads
from _torch_parity import e2e_fixture, repeat_fixture
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.ops import rank as jrank
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops import rank as trank
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.ops import step as tstep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    return e2e_fixture(tmp_path_factory.mktemp("torch_seed"))


@pytest.fixture(scope="module")
def rep(tmp_path_factory):
    return repeat_fixture(tmp_path_factory.mktemp("torch_seed_rep"))


def _cfgs(d, params, B, L, **kw):
    jc = replace(jpipe.MapperConfig.from_params(params, d["meta"], B, L), **kw)
    tc = replace(tpipe.MapperConfig.from_params(params, d["tmeta"], B, L),
                 **kw)
    return jc, tc


def _seed_vote_both(d, params, reads, B, L, **kw):
    jc, tc = _cfgs(d, params, B, L, **kw)
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], params, chunk_b=B,
                     device="cpu")
    codes, _, lens, _ = tm._pack_reads(reads, L, B)
    want = jax.jit(lambda i, c, l: jpipe._seed_vote(jc, i, c, l))(
        d["idx"], jnp.asarray(codes), jnp.asarray(lens))
    got = tpipe._seed_vote(tc, d["tidx"], torch.from_numpy(codes),
                           torch.from_numpy(lens))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_occ_and_backward_step_match_jax(e2e):
    rng = np.random.default_rng(0)
    idx, tidx, meta = e2e["idx"], e2e["tidx"], e2e["meta"]
    m = 4096
    c = rng.integers(0, 5, m).astype(np.int32)             # incl. N lanes
    loc = rng.integers(0, meta.n, m).astype(np.int32)
    cc = np.minimum(c, 3)
    want = jrank.occ(idx.packed, idx.occ_samp, meta.dollar_pos,
                     jnp.asarray(cc), jnp.asarray(loc))
    got = trank.occ(tidx.packed, tidx.occ_samp, meta.dollar_pos,
                    torch.from_numpy(cc), torch.from_numpy(loc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    k = rng.integers(0, meta.n, m).astype(np.int32)
    l = np.minimum(k + rng.integers(-5, 400, m), meta.n - 1).astype(np.int32)
    active = rng.random(m) < 0.8
    want = jrank.backward_step(idx.c4, idx.packed, idx.occ_samp,
                               meta.dollar_pos, jnp.asarray(k),
                               jnp.asarray(l), jnp.asarray(c),
                               jnp.asarray(active))
    got = trank.backward_step(tidx.c4, tidx.packed, tidx.occ_samp,
                              meta.dollar_pos, torch.from_numpy(k),
                              torch.from_numpy(l), torch.from_numpy(c),
                              torch.from_numpy(active))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_seed_vote_matches_jax_with_ns(e2e):
    params = Params(hlen=6, seed_len=20, thres=300)
    rng = np.random.default_rng(3)
    reads = sample_reads(rng, e2e["chrA"], 10, 200, error_rate=0.03) + \
        sample_reads(rng, e2e["chrB"], 4, 150, error_rate=0.0)
    reads = [(n, s, None) for n, s, *_ in reads]
    for i in (0, 3, 11):                           # N-containing reads
        s = np.frombuffer(reads[i][1].encode(), np.uint8).copy()
        s[rng.integers(0, len(s), 6)] = ord("N")
        reads[i] = (reads[i][0], s.tobytes().decode(), None)
    reads.append(("junk", "ACGT" * 50, None))
    want, got = _seed_vote_both(e2e, params, reads, 16, 256)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_seed_vote_wide_seeds_match_jax(rep):
    params = Params(hlen=6, thres=30)
    cfg = tpipe.MapperConfig.from_params(params, rep["tmeta"], 8, 256)
    tm = TorchMapper(rep["tidx"], rep["tmeta"], rep["mta"], params,
                     chunk_b=8, device="cpu")
    codes, _, lens, _ = tm._pack_reads(rep["reads"], 256, 8)
    # the fixture must exercise the LF-narrowing branch
    qw, num, ok = tsv._position_tables(cfg, torch.from_numpy(codes))
    kl = rep["tidx"].lch[tsv._by_phase(cfg, num).clamp(0, 4095).long()]
    assert ((kl[..., 1] - kl[..., 0] + 1 >= cfg.thres)
            & tsv._by_phase(cfg, ok)).any()
    want, got = _seed_vote_both(rep, params, rep["reads"], 8, 256)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert not got[1].any()


def test_seed_vote_wide_lane_overflow_matches_jax(rep):
    """A 4-lane wide budget drops wide seeds: the rows flag overflow."""
    params = Params(hlen=6, thres=30)
    want, got = _seed_vote_both(rep, params, rep["reads"], 8, 256,
                                wide_budget=4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[1].any()


def test_seq_lookup_matches_jax(e2e):
    rng = np.random.default_rng(8)
    n = e2e["meta"].n
    loc = np.concatenate([rng.integers(-50, n + 50, 200),
                          [0, 15999, 16000, 31999, 32000, 47999, 48000,
                           n - 1]]).astype(np.int32)
    qlen = rng.integers(0, 300, loc.shape[0]).astype(np.int32)
    want = jpipe._seq_lookup(e2e["idx"], jnp.asarray(loc), jnp.asarray(qlen))
    got = tstep._seq_lookup(e2e["tidx"], torch.from_numpy(loc),
                            torch.from_numpy(qlen))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
