"""The mapping step's glue (ops/step.py) on the CPU, where each wrapper runs
its plain version: the locate against the JAX package's _seq_lookup on
contig tables with zero-length contigs, reads of length 0, reads on the
boundaries between contigs and between a contig's halves, unfound reads,
int32 positions that wrap near 2^31 - 1, and an int64 table with starts
above 2^32 (JAX in x64 mode in a process of its own); the target window
against the .cat codes at all 16 sub-word offsets; the raw encode against
JAX raw_step's ops on rows with garbage past the read, and on a ragged
part, each row at its own length, against the mapper's host encode; the
walk's inputs and the pack against numpy (the pack: a stable partition
with the pads last, in int16 and int32 entries, the pos64 meta words,
heads of whole entries and heads larger than the row).  The card holds each kernel to
these plain versions (tests/test_torch_glue_card.py, chip_smoke.py phase
3c)."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _glue_inputs as G
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu_torch.models import mapper as tmapper
from longreadmapper_tpu_torch.ops import step as tstep

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(name):
    start, slen, n = G.contig_table(name)
    return SimpleNamespace(mta_start=torch.from_numpy(start),
                           mta_len=torch.from_numpy(slen)), n


@pytest.mark.parametrize("name", ["int32", "wrap"])
def test_seq_lookup_matches_jax_on_edge_tables(name):
    idx, _ = _table(name)
    loc, qlen = G.locate_case(name, np.random.default_rng(1))
    jidx = SimpleNamespace(mta_start=jnp.asarray(idx.mta_start.numpy()),
                           mta_len=jnp.asarray(idx.mta_len.numpy()))
    want = jpipe._seq_lookup(jidx, jnp.asarray(loc), jnp.asarray(qlen))
    got = tstep._seq_lookup(idx, torch.from_numpy(loc),
                            torch.from_numpy(qlen))
    for w, g in zip(want, got):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    found, gi = got[0].numpy(), got[1].numpy()
    # zero-length contigs, and the edges between contigs and halves, are
    # decided by the first hit: some reads hit a later contig, some none
    assert found.any() and (~found).any() and (gi[found] > 0).any()
    if name == "wrap":
        assert (loc.astype(np.int64) + qlen > G.I31).any()


X64_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from types import SimpleNamespace
import jax.numpy as jnp
import numpy as np
from longreadmapper_tpu.mapping import pipeline as jpipe
d = np.load(sys.argv[2])
idx = SimpleNamespace(mta_start=jnp.asarray(d["start"]),
                      mta_len=jnp.asarray(d["slen"]))
out = jpipe._seq_lookup(idx, jnp.asarray(d["loc"]), jnp.asarray(d["qlen"]))
np.savez(sys.argv[3], **{f"o{i}": np.asarray(x) for i, x in enumerate(out)})
"""


def test_seq_lookup_int64_table_matches_jax_x64(tmp_path):
    """Starts above 2^32: int64 offsets and positions, JAX in x64 mode."""
    start, slen, _ = G.contig_table("int64")
    loc, qlen = G.locate_case("int64", np.random.default_rng(2))
    np.savez(tmp_path / "in.npz", start=start, slen=slen, loc=loc,
             qlen=qlen)
    r = subprocess.run([sys.executable, "-c", X64_WORKER, ROOT,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    idx = SimpleNamespace(mta_start=torch.from_numpy(start),
                          mta_len=torch.from_numpy(slen))
    got = tstep._seq_lookup(idx, torch.from_numpy(loc),
                            torch.from_numpy(qlen))
    assert got[3].dtype == got[4].dtype == torch.int64
    assert (got[4].numpy()[got[0].numpy()] > 1 << 32).all()
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), want[f"o{i}"], err_msg=i)


@pytest.mark.parametrize("L", [16, 64, 1024])
def test_target_window_is_the_cat_codes(L):
    """t at every sub-word offset equals the .cat codes from safe_loc on,
    5 from position n - 1 ('$') on; q is the read on its strand."""
    rng = np.random.default_rng(L)
    idx, loc, qlen, text = G.window_case(rng, L)
    n = text.shape[0]
    B = loc.shape[0]
    codes = rng.integers(0, 5, (B, L)).astype(np.int8)
    codes_rc = rng.integers(0, 5, (B, L)).astype(np.int8)
    found, gi, strand, off, loc_fwd, safe, q, t = tstep.locate_window_plain(
        G.cfg(B, L, n), idx, torch.from_numpy(loc), torch.from_numpy(qlen),
        torch.from_numpy(codes), torch.from_numpy(codes_rc))
    safe = safe.numpy().astype(np.int64)
    assert set(range(16)) <= set(safe % 16)
    assert (safe > n - 1 - L).any() and (~found.numpy()).any()
    pos = safe[:, None] + np.arange(L)[None, :]
    want_t = np.where(pos >= n - 1, 5, text[np.minimum(pos, n - 1)])
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(
        q.numpy(), np.where(strand.numpy()[:, None], codes_rc, codes))
    np.testing.assert_array_equal(
        safe, np.where(found.numpy(), loc_fwd.numpy(), 0).clip(0, n - 1))


def _jax_raw_encode(raw, lens, L):
    """JAX raw_step's encode (longreadmapper_tpu/mapping/pipeline.py,
    make_map_step.raw_step), op for op."""
    u = raw | jnp.uint8(32)
    codes = jnp.where(
        u == ord("a"), 0, jnp.where(
            u == ord("c"), 1, jnp.where(
                u == ord("g"), 2, jnp.where(
                    u == ord("t"), 3, 4)))).astype(jnp.int8)
    comp = jnp.where(codes < 4, 3 - codes, codes)
    codes_rc = jnp.roll(comp[:, ::-1], jnp.max(lens) - np.int32(L), axis=1)
    return codes, codes_rc


@pytest.mark.parametrize("B,L,L0", [
    (5, 64, 37), (3, 128, 128), (2, 48, 0), (1, 1024, 1000),
    # L % 16 != 0: the kernel's per-byte edge
    (3, 50, 23), (2, 37, 37),
    # L0 15, 16 and 17 past the kernel's 2048-base chunk boundary
    (2, 4096, 2063), (2, 4096, 2064), (2, 4096, 2065),
    # a ragged part, each row at its own length (L0 None): lengths 0, 1,
    # 15-17, 2063-2065 and L, L % 16 != 0, lowercase and N
    pytest.param(None, 4099, None, id="ragged")])
def test_encode_raw_matches_jax_raw_step(B, L, L0):
    """Rows of one length L0 (garbage past it) against JAX raw_step's
    encode, which takes one length; a ragged part's rows, as the mapper
    packs them (_raw_rows), against its host encode (_host_codes), row
    for row and byte for byte."""
    if L0 is None:
        part = G.ragged_case(np.random.default_rng(L), L)
        raw, lens = tmapper._raw_rows(part, L, len(part) + 2)
        codes, codes_rc, host_lens = tmapper._host_codes(part, L,
                                                         len(part) + 2)
        np.testing.assert_array_equal(lens, host_lens)
        assert sorted(lens[:len(part)]) == sorted(G.RAGGED_LENS + (L,))
        want = (codes, codes_rc)
    else:
        raw = G.raw_case(np.random.default_rng(L0), B, L, L0)
        lens = np.full(B, L0, np.int32)
        want = _jax_raw_encode(jnp.asarray(raw), jnp.asarray(lens), L)
    got = tstep.encode_raw(torch.from_numpy(raw), torch.from_numpy(lens))
    for w, g in zip(want, got):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("narrow", [False, True])
def test_lanes_match_numpy(narrow):
    B, L, Wp = 300, 40, 64
    wcol, lens, limit, found, ovf = G.lanes_case(np.random.default_rng(5),
                                                  B, L)
    got = tstep.lanes(torch.from_numpy(wcol), torch.from_numpy(lens),
                      torch.from_numpy(limit), torch.from_numpy(found),
                      torch.from_numpy(ovf), Wp, narrow)
    ed = wcol[lens, np.arange(B)].astype(np.int32)
    short = narrow & found & (ed >= Wp) & (limit >= Wp)
    alive = found & (ed <= limit) & ~short
    want = (ed, short, ovf.astype(np.int32) | np.where(short, 4, 0),
            np.where(alive, lens, 0))
    assert short.any() == narrow and alive.any() and (~alive).any()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def _pack_numpy(c, v, saturated):
    """The blob and the tail by a numpy stable partition per row."""
    runs = v["runs"]
    B, R = runs.shape
    K = runs.itemsize * R
    ovf = v["overflow"] | (2 if saturated else 0)
    ed = np.where((v["ed_raw"] <= v["limit"]) & ~v["band_short"],
                  v["ed_raw"], -1)
    pos = [v["best"], v["off"]]
    if c.pos64:
        pos = [p.astype(np.int64).view(np.int32).reshape(B, 2) for p in pos]
        cols = [pos[0][:, 0], pos[0][:, 1], v["found"], v["gi"], v["strand"],
                pos[1][:, 0], pos[1][:, 1], ed, v["limit"], ovf]
    else:
        cols = [pos[0], v["found"], v["gi"], v["strand"], pos[1], ed,
                v["limit"], ovf]
    meta = np.stack([np.asarray(x).astype(np.int32) for x in cols], axis=1)
    pad = (runs & 3) == 3
    compact = np.stack([np.concatenate([r[~p], r[p]])
                        for r, p in zip(runs, pad)])
    rows = compact.view(np.int8).reshape(B, K)
    head = K if c.use_gact else min(16, K) - min(16, K) % runs.itemsize
    return (np.concatenate([meta.view(np.int8).reshape(B, -1),
                            rows[:, :head]], axis=1), rows[:, head:])


@pytest.mark.parametrize("R,eb,pos64,gact", [
    (40, 2, False, False), (40, 4, False, False), (40, 2, True, False),
    (3, 2, False, False), (3, 4, True, False), (70, 2, True, True),
    (5, 2, False, True),
    # odd R in gact (a blob pitch only 2-aligned), R past 16-byte slots
    (71, 2, False, True), (45, 4, True, False),
    # a large R: past the kernel's 32 KB tile of entries
    (8500, 4, False, False)])
@pytest.mark.parametrize("saturated", [None, True, False])
def test_pack_is_a_stable_partition(R, eb, pos64, gact, saturated):
    """Pad entries (op 3, of different counts) last in their own order,
    the others first in path order; rows all pads and none; heads of
    whole entries, the whole row on the gact path and a head larger than
    a short row; odd rows and a row of 34,000 bytes."""
    vals = G.pack_case(np.random.default_rng(R * eb), 9, R, eb, pos64)
    v = G.to_torch(vals)
    c = G.cfg(9, 64, 1000, pos64=pos64, use_gact=gact, entry_bytes=eb)
    sat = None if saturated is None else torch.tensor(saturated)
    got = tstep.pack(c, v["best"], v["found"], v["gi"], v["strand"],
                     v["off"], tstep.Lanes(v["ed_raw"], v["band_short"],
                                           v["overflow"]),
                     v["limit"], v["runs"], sat)
    blob, tail = _pack_numpy(c, vals, saturated)
    np.testing.assert_array_equal(got["blob"].numpy(), blob)
    np.testing.assert_array_equal(got["ops_tail"].numpy(), tail)
    assert got["blob"].shape[1] == 4 * c.meta_words + min(
        R * eb, R * eb if gact else 16)


# ---------------------------------------------------------------- G3 fused

def _jax_lanes(wcol, lens, limits, found, overflow, Wp, narrow):
    """JAX's expressions for the walk's inputs, op for op: the narrow pass
    (longreadmapper_tpu/mapping/pipeline.py:896-910 on the gact path,
    :972-977 on the resident one; the same bit 2 either way), alive and
    lens_tb, ed_raw at :989."""
    B = wcol.shape[1]
    found = jnp.asarray(found)
    limits = jnp.asarray(limits)
    lens = jnp.asarray(lens)
    wcol = jnp.asarray(wcol)
    ed_pre = wcol[lens, jnp.arange(B)].astype(jnp.int32)
    if narrow:
        band_short = found & (ed_pre >= jnp.int32(Wp)) & \
            (jnp.int32(Wp) <= limits.astype(jnp.int32))
    else:
        band_short = jnp.zeros_like(found)
    overflow = jnp.asarray(overflow).astype(jnp.int32) | \
        jnp.where(band_short, jnp.int32(4), jnp.int32(0))
    alive = found & (ed_pre <= limits.astype(jnp.int32)) & ~band_short
    lens_tb = jnp.where(alive, lens.astype(jnp.int32), 0)
    ed_raw = wcol[lens, jnp.arange(B)].astype(jnp.int32)
    return ed_raw, band_short, overflow, lens_tb


def _lane_case(case):
    if case == "edges":
        return G.lanes_edges(40, 64)
    return G.lanes_case(np.random.default_rng(7), 300, 40)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("case", ["random", "edges"])
def test_lane_model_matches_plain_and_jax(case, narrow):
    """csrc/lanes.cuh::lane_of, modelled lane by lane as the CUDA is
    written, equals lanes_plain and JAX's expressions: random lanes, and
    len 0 and L, found false, ed == Wp at limit Wp, narrow on and off,
    the seed vote's overflow set."""
    arrays = _lane_case(case)
    B = arrays[0].shape[1]
    model = np.array([G.model_lane(*arrays, 64, narrow, b)
                      for b in range(B)]).T
    plain = tstep.lanes_plain(*(torch.from_numpy(a) for a in arrays), 64,
                              narrow)
    want = _jax_lanes(*arrays, 64, narrow)
    for m, p, w in zip(model, plain, want):
        np.testing.assert_array_equal(p.numpy().astype(np.int64), m)
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    ed, short, ovf, walk = model
    assert (walk > 0).any() and (walk == 0).any()
    assert short.any() == narrow and (ovf & 1).any()
    if case == "edges":
        assert short[3] == narrow and not short[4] and walk[5] > 0
        assert walk[0] == 0 and walk[2] == 0 and walk[6] == 5


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("case", ["random", "edges"])
def test_lanes_record_on_cpu(case, narrow):
    """On CPU tensors `lanes` is a Lanes of lanes_plain's four values, and
    the gact setup on it equals the plain setup of its lens_tb."""
    arrays = [torch.from_numpy(a) for a in _lane_case(case)]
    ln = tstep.lanes(*arrays, 64, narrow)
    assert ln.src is None and ln.written
    for g, w in zip((ln.ed_raw, ln.band_short, ln.overflow, ln.lens_tb),
                    tstep.lanes_plain(*arrays, 64, narrow)):
        assert torch.equal(g, w)
    for a, b in zip(tstep.gact_setup(ln, 9),
                    tstep.gact_setup_plain(ln.lens_tb, 9)):
        assert torch.equal(a, b)


def _eager_gact_state(lens, n_rows):
    """What ops/gact.py built before the setup kernel (its lines 151 and
    156-160), op for op."""
    B = lens.shape[0]
    buf = torch.full((B, n_rows, 2), 3, dtype=torch.int16)
    l32 = lens.to(torch.int32)
    st = torch.cat([l32, l32, (l32 <= 0).to(torch.int32),
                    torch.zeros(3, dtype=torch.int32)])
    return st, buf.reshape(B, -1)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("case,n_rows", [("random", 7), ("edges", 1),
                                         ("edges", 33), ("given", 5)])
def test_gact_setup_matches_the_eager_build(case, n_rows, narrow):
    """csrc/step.cu::lanes_kernel, modelled thread by thread over garbage
    (the walk state from lane_of's walk length, the shared words zeroed,
    the buffer filled four pad pairs a store and the rest one at a time),
    and gact_setup_plain, equal the eager build ops/gact.py made of
    lanes_plain's lens_tb; and of given lengths, negative ones among
    them (done where <= 0)."""
    if case == "given":
        lens = np.random.default_rng(n_rows).integers(-3, 50, 21).astype(
            np.int32)
        B = lens.shape[0]
        model = G.model_gact_setup(lambda b: int(lens[b]), B, n_rows)
        lens_tb = torch.from_numpy(lens)
    else:
        arrays = _lane_case(case)
        B = arrays[0].shape[1]
        model = G.model_gact_setup(
            lambda b: G.model_lane(*arrays, 64, narrow, b)[3], B, n_rows)
        lens_tb = tstep.lanes_plain(*(torch.from_numpy(a) for a in arrays),
                                    64, narrow)[3]
    want = _eager_gact_state(lens_tb, n_rows)
    plain = tstep.gact_setup_plain(lens_tb, n_rows)
    for m, p, w in zip(model, plain, want):
        assert p.dtype == w.dtype and p.shape == w.shape
        np.testing.assert_array_equal(m, w.numpy())
        assert torch.equal(p, w)


@pytest.mark.parametrize("B,n_rows,threads,max_blocks", [
    (100, 1, 32, 1),      # 103 lane items past the fill's 32 threads
    (62, 2, 32, 1),       # the shared words alone past them
    (70, 9, 32, 2),       # the fill strides, the lanes do not
    (29, 3, 16, 1)])      # lanes and shared words past the fill's grid
def test_gact_setup_model_covers_lanes_past_the_fill_cap(B, n_rows, threads,
                                                         max_blocks):
    """lanes_kernel where the fill's capped grid (lrm_gact_setup caps it
    at 4096 blocks) has fewer threads than B + 3 (past 1,048,573 lanes):
    the launch still gives every lane and shared word a thread, so each
    is written, equal to the eager build."""
    lens = np.random.default_rng(B).integers(-3, 50, B).astype(np.int32)
    model = G.model_gact_setup(lambda b: int(lens[b]), B, n_rows, threads,
                               max_blocks)
    assert min(-(-(B * n_rows // 4) // threads),
               max_blocks) * threads < B + 3
    for m, w in zip(model, _eager_gact_state(torch.from_numpy(lens),
                                             n_rows)):
        np.testing.assert_array_equal(m, w.numpy())


def test_pack_refuses_lanes_no_walk_has_written():
    """A Lanes on the card's route (lanes' values not yet computed) is
    not written until a walk's launch computes them: pack raises rather
    than pack the garbage; a Lanes of given values packs."""
    B, R = 5, 12
    vals = G.pack_case(np.random.default_rng(3), B, R, 2, False)
    v = G.to_torch(vals)
    c = G.cfg(B, 64, 1000)
    arrays = [torch.from_numpy(a) for a in G.lanes_case(
        np.random.default_rng(4), B, 40)]
    ln = tstep._lanes_in(*arrays, 64, True)
    assert not ln.written and ln.lens_tb is None
    head = (c, v["best"], v["found"], v["gi"], v["strand"], v["off"])
    with pytest.raises(ValueError, match="no walk's launch"):
        tstep.pack(*head, ln, v["limit"], v["runs"])
    ln.written = True
    got = tstep.pack(*head, ln, v["limit"], v["runs"])
    want = tstep.pack_plain(*head, ln.ed_raw, v["limit"], ln.band_short,
                            ln.overflow, v["runs"], None)
    for k in want:
        assert torch.equal(got[k], want[k])
