"""The step glue's CUDA kernels (csrc/step.cu) on the card against their
plain versions (ops/step.py), bit for bit, on the CPU tests' inputs
(tests/_glue_inputs.py): encode_kernel on rows with garbage past the read,
down both of its paths (16 bases a thread where L % 16 == 0 and every
pointer is 16-aligned; a byte at a time where L % 16 != 0 or raw starts
off a 16-byte boundary), with L0 0, L0 = L and L0 either side of a CTA's
2048-base chunk, and a ragged part, each row at its own length, against
the host encode too; locate_window_kernel on the edge tables (zero-length
contigs, boundaries, reads of length 0, int32 wrap near 2^31 - 1, an
int64 table above 2^32), at every sub-word offset, and over a text that
stands for a row-sharded one (two launches, the words gathered between
them); G3 on its fused route in both modes (lanes_kernel, the gact walk's
setup, from the lanes' inputs, the lanes' values it writes for the pack
among its outputs, and from given lengths); pack_kernel in int16 and int32
entries, pos64, the gact head and the saturation bit, down its three
paths (a warp a row up to 64 16-byte slots; a CTA a row up to 2048; tiles
after a count pass beyond), with rows that start off a 16-byte boundary
(R not a multiple of the entries in 16 bytes) and blob rows only
2-aligned (odd R, int16, gact); each also at B = 1 and B = 3, and with
every output allocated over memory filled with garbage (torch.empty and
Tensor.new_empty patched: the kernel must write every byte); then a
whole raw step on the card, byte-equal to the CPU's, that launched the
glue's kernels (G3 in walk_c) and called no plain version.

Card-only: the tests skip where torch.cuda.is_available() is false, and
import no JAX, so they run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_glue_card.py
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _glue_inputs as G  # noqa: E402
from longreadmapper_tpu_torch.index.device import load_device_index  # noqa
from longreadmapper_tpu_torch.mapping import pipeline as tpipe  # noqa
from longreadmapper_tpu_torch.models import mapper as tmapper  # noqa
from longreadmapper_tpu_torch.models.mapper import TorchMapper  # noqa
from longreadmapper_tpu_torch.ops import step as tstep  # noqa: E402
from longreadmapper_tpu_torch.runtime.accidx import build_index  # noqa
from longreadmapper_tpu_torch.utils.config import Params  # noqa: E402

torch.set_num_threads(1)
WRAPPERS = (tstep.encode_raw, tstep.locate_window, tstep.lanes, tstep.pack)
PLAINS = (tstep.encode_raw_plain, tstep.locate_window_plain,
          tstep.lanes_plain, tstep.pack_plain)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


class _Rows:
    """A table that is not a tensor, gathered by indexing, as a
    ShardedRows block is (parallel/dist.py) but on one device: it sends
    locate_window down its two-launch path."""

    def __init__(self, t):
        self.t, self.shape, self.dtype = t, t.shape, t.dtype

    def __getitem__(self, i):
        return self.t[i]


def _dirty(t):
    t.view(-1).view(torch.uint8).fill_(0xA5)
    return t


def _run(wrapper, args, garbage: bool, launches: int = 1, counter=None):
    """wrapper(*args) on the card, its outputs allocated over garbage
    bytes when `garbage` (torch.empty and Tensor.new_empty patched);
    checks the launch count of `counter` (the wrapper's by default)."""
    counter = counter or wrapper
    n = counter.launches
    if garbage:
        empty, new_empty = torch.empty, torch.Tensor.new_empty
        torch.empty = lambda *a, **kw: _dirty(empty(*a, **kw))
        torch.Tensor.new_empty = (
            lambda self, *a, **kw: _dirty(new_empty(self, *a, **kw)))
        try:
            got = wrapper(*args)
        finally:
            torch.empty = empty
            del torch.Tensor.new_empty          # the inherited one again
    else:
        got = wrapper(*args)
    assert counter.launches == n + launches
    return got


def _equal(got, want):
    torch.cuda.synchronize()
    if isinstance(got, dict):
        got, want = list(got.values()), list(want.values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.shape == w.shape
        assert torch.equal(g, w)


def _rows(x, B):
    """The first B reads of each per-read array (all of them for None)."""
    return x if B is None else np.ascontiguousarray(x[:B])


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("B,L,L0", [
    (1, 64, 37), (3, 128, 128), (2, 48, 0), (2048, 1024, 1000),
    (40, 50176, 50000),
    (3, 50, 23), (2, 37, 37),                  # L % 16 != 0: a byte a time
    # 16 bases a thread: L0 15, 16, 17 past a CTA's 2048-base chunk (the
    # reverse complement's windows straddle L0 in the second CTA), L0 0
    # and L0 = L, B 1
    (2, 4096, 2063), (2, 4096, 2064), (2, 4096, 2065), (2, 1024, 0),
    (2, 1024, 1024), (1, 4096, 2064)])
def test_encode_kernel_matches_plain_on_card(B, L, L0, garbage):
    _card()
    raw = torch.from_numpy(G.raw_case(np.random.default_rng(L0), B, L,
                                      L0)).cuda()
    lens = torch.full((B,), L0, dtype=torch.int32, device="cuda")
    got = _run(tstep.encode_raw, (raw, lens), garbage)
    _equal(got, tstep.encode_raw_plain(raw, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("L", [4096, 4099])
def test_encode_kernel_ragged_matches_host_on_card(L, garbage):
    """A ragged part as the mapper packs it (_raw_rows: lengths 0, 1,
    15-17, 2063-2065 and L, two pad rows, lowercase and N), each row at
    its own length, down both paths (L 4096: 16 bases a thread; 4099: a
    byte a time): equal to the plain version and to the host encode
    (_host_codes), row for row."""
    _card()
    part = G.ragged_case(np.random.default_rng(L), L)
    raw, lens = tmapper._raw_rows(part, L, len(part) + 2)
    raw, lens = torch.from_numpy(raw).cuda(), torch.from_numpy(lens).cuda()
    got = _run(tstep.encode_raw, (raw, lens), garbage)
    _equal(got, tstep.encode_raw_plain(raw, lens))
    _equal(got, [torch.from_numpy(a).cuda() for a in
                 tmapper._host_codes(part, L, len(part) + 2)[:2]])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 16])
def test_encode_kernel_unaligned_raw_on_card(offset):
    """raw starting `offset` bytes into an allocation: off a 16-byte
    boundary the kernel takes its bytes one at a time (L % 16 == 0)."""
    _card()
    B, L, L0 = 3, 256, 200
    raw = torch.from_numpy(G.raw_case(np.random.default_rng(offset), B, L,
                                      L0)).cuda()
    big = torch.zeros(B * L + offset, dtype=torch.uint8, device="cuda")
    big[offset:] = raw.reshape(-1)
    raw = big[offset:].view(B, L)
    lens = torch.full((B,), L0, dtype=torch.int32, device="cuda")
    got = _run(tstep.encode_raw, (raw, lens), True)
    _equal(got, tstep.encode_raw_plain(raw, lens))


def _locate_args(name, rng, B=None, L=32, sharded=False):
    start, slen, n = G.contig_table(name)
    loc, qlen = G.locate_case(name, rng)
    _, packed = G.text(rng, 1001)
    tp = torch.from_numpy(packed).cuda()
    idx = SimpleNamespace(mta_start=torch.from_numpy(start).cuda(),
                          mta_len=torch.from_numpy(slen).cuda(),
                          text_packed=_Rows(tp) if sharded else tp)
    loc, qlen = _rows(loc, B), _rows(qlen, B)
    Bn = loc.shape[0]
    codes = rng.integers(0, 5, (Bn, L)).astype(np.int8)
    rc = rng.integers(0, 5, (Bn, L)).astype(np.int8)
    return (G.cfg(Bn, L, n, pos64=name == "int64"), idx) + tuple(
        torch.from_numpy(x).cuda() for x in (loc, qlen, codes, rc))


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("B", [None, 1, 3])
@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("name", list(G.TABLES))
def test_locate_window_kernel_matches_plain_on_card(name, sharded, B,
                                                    garbage):
    _card()
    args = _locate_args(name, np.random.default_rng(1), B, sharded=sharded)
    got = _run(tstep.locate_window, args, garbage, 2 if sharded else 1)
    if sharded:
        args[1].text_packed = args[1].text_packed.t
    _equal(got, tstep.locate_window_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("L", [16, 64, 1024, 10240])
def test_window_kernel_at_every_offset_on_card(L, garbage):
    _card()
    rng = np.random.default_rng(L)
    idx, loc, qlen, _ = G.window_case(rng, L, n=30001)
    idx = SimpleNamespace(**{k: v.cuda() for k, v in vars(idx).items()})
    B = loc.shape[0]
    args = (G.cfg(B, L, 30001), idx) + tuple(
        torch.from_numpy(x).cuda() for x in (
            loc, qlen, rng.integers(0, 5, (B, L)).astype(np.int8),
            rng.integers(0, 5, (B, L)).astype(np.int8)))
    _equal(_run(tstep.locate_window, args, garbage),
           tstep.locate_window_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("B,L", [(1, 40), (3, 16), (300, 40),
                                 (2048, 1024)])
def test_lanes_kernel_matches_plain_on_card(B, L, narrow, garbage):
    """G3 on its fused route against lanes_plain: `lanes` launches
    nothing; lanes_kernel (the gact walk's setup) on the Lanes writes the
    lanes' ed_raw, band_short and overflow equal to lanes_plain's, and the
    walk state and run buffer equal to gact_setup_plain of its lens_tb;
    one launch counted in lanes.launches."""
    _card()
    w, lens, lim, found, ovf = G.lanes_case(np.random.default_rng(B), B, L)
    args = tuple(torch.from_numpy(x).cuda() for x in (w, lens, lim, found,
                                                      ovf)) + (64, narrow)
    ln = _run(tstep.lanes, args, garbage, 0)
    ed, short, overflow, lens_tb = tstep.lanes_plain(*args)
    _equal(_run(tstep.gact_setup, (ln, 7), garbage, 1, tstep.lanes),
           tstep.gact_setup_plain(lens_tb, 7))
    _equal([ln.ed_raw, ln.band_short, ln.overflow], [ed, short, overflow])
    assert ln.lens_tb is None


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("B,n_rows", [(1, 3), (3, 1), (40, 5228),
                                      (200, 2124), (2048, 5)])
def test_gact_setup_kernel_matches_eager_on_card(B, n_rows, given):
    """lanes_kernel, the gact walk's setup, over garbage: st and the run
    buffer equal the eager build (gact_setup_plain) of lanes_plain's
    lens_tb, or of given lengths (negative ones among them); one launch,
    counted in lanes.launches for a Lanes only."""
    _card()
    rng = np.random.default_rng(B + n_rows)
    w, lens, lim, found, ovf = G.lanes_case(rng, B, 64)
    args = tuple(torch.from_numpy(x).cuda() for x in (w, lens, lim, found,
                                                      ovf)) + (64, True)
    if given:
        lens = torch.from_numpy(rng.integers(-3, 64, B).astype(
            np.int32)).cuda()
        got = _run(tstep.gact_setup, (lens, n_rows), True, 0, tstep.lanes)
    else:
        lens = tstep.lanes_plain(*args)[3]
        got = _run(tstep.gact_setup, (tstep.lanes(*args), n_rows), True, 1,
                   tstep.lanes)
    _equal(got, tstep.gact_setup_plain(lens, n_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("saturated", [None, True, False])
@pytest.mark.parametrize("B,R,eb,pos64,gact", [
    (1, 40, 2, False, False), (3, 3, 4, True, False), (9, 70, 2, True, True),
    (2048, 26, 2, False, False), (200, 300, 4, False, False),
    (40, 5000, 2, True, True), (3, 1, 2, False, False),
    (2, 10456, 2, True, True), (3, 8292, 4, False, False),
    # a warp a row: odd R, int16, gact (blob rows 2-aligned); R not a
    # multiple of 8 (int16) or 4 (int32) entries, so rows start off a
    # 16-byte boundary and the 16-byte loads leave edges
    (9, 71, 2, False, True), (4, 45, 2, False, False),
    (4, 45, 4, True, False),
    # tiles after a count pass: 240,000 bytes of entries a row (3, 8292,
    # 4 above also takes the tiles; 2, 10456 and 40, 5000 a CTA a row)
    (2, 60000, 4, False, False)])
def test_pack_kernel_matches_plain_on_card(B, R, eb, pos64, gact,
                                           saturated, garbage):
    _card()
    v = G.to_torch(G.pack_case(np.random.default_rng(R * eb), B, R, eb,
                               pos64), "cuda")
    c = G.cfg(B, 64, 1000, pos64=pos64, use_gact=gact, entry_bytes=eb)
    sat = None if saturated is None else torch.tensor(saturated).cuda()
    head = (c, v["best"], v["found"], v["gi"], v["strand"], v["off"])
    ln = tstep.Lanes(v["ed_raw"], v["band_short"], v["overflow"])
    _equal(_run(tstep.pack, head + (ln, v["limit"], v["runs"], sat),
                garbage),
           tstep.pack_plain(*head, v["ed_raw"], v["limit"],
                            v["band_short"], v["overflow"], v["runs"], sat))


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,eb,gact", [
    (40, 70, 2, False),        # a warp a row
    (40, 5000, 2, True),       # a CTA a row, the whole row eager
    (3, 8292, 4, False)])      # tiles after a count pass
def test_pack_of_lanes_needs_the_walk_on_card(B, R, eb, gact):
    """A Lanes from `lanes` on the card holds no values until a walk's
    launch writes them: pack raises on it (no launch), still raises after
    a walk refused at its checks, and after the gact setup's launch packs
    bit-equal to pack_plain on lanes_plain's values, on each of the
    pack's three paths."""
    _card()
    v = G.to_torch(G.pack_case(np.random.default_rng(R), B, R, eb, False),
                   "cuda")
    c = G.cfg(B, 64, 1000, use_gact=gact, entry_bytes=eb)
    args = tuple(torch.from_numpy(x).cuda() for x in G.lanes_case(
        np.random.default_rng(B), B, 64)) + (64, True)
    ln = tstep.lanes(*args)
    head = (c, v["best"], args[3], v["gi"], v["strand"], v["off"])
    n = tstep.pack.launches
    with pytest.raises(ValueError, match="no walk's launch"):
        tstep.pack(*head, ln, args[2], v["runs"])
    # a walk refused at its checks (vdirs of another B) leaves it unwritten
    from longreadmapper_tpu_torch.ops import traceback as ttb
    bad = torch.zeros((4, B + 1, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        ttb.device_traceback_c(bad, ln, 64, 30, bad[:1])
    with pytest.raises(ValueError, match="no walk's launch"):
        tstep.pack(*head, ln, args[2], v["runs"])
    assert tstep.pack.launches == n
    tstep.gact_setup(ln, 5)
    ed, short, overflow, _ = tstep.lanes_plain(*args)
    _equal(tstep.pack(*head, ln, args[2], v["runs"]),
           tstep.pack_plain(*head, ed, args[2], short, overflow, v["runs"],
                            None))


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("B", [4096 * 256 - 1, 4096 * 256 + 37])
def test_gact_setup_kernel_past_the_fill_cap_on_card(B, given):
    """lrm_gact_setup caps the fill's grid at 4096 blocks of 256 threads:
    past B + 3 = 1,048,576 items the launch still gives every lane and
    shared word a thread, and each is written over garbage, equal to the
    eager build."""
    _card()
    rng = np.random.default_rng(B)
    if given:
        lens = torch.from_numpy(rng.integers(-3, 64, B).astype(
            np.int32)).cuda()
        got = _run(tstep.gact_setup, (lens, 1), True, 0, tstep.lanes)
    else:
        args = tuple(torch.from_numpy(x).cuda() for x in G.lanes_case(
            rng, B, 16)) + (64, True)
        ln = tstep.lanes(*args)
        got = _run(tstep.gact_setup, (ln, 1), True, 1, tstep.lanes)
        lens = tstep.lanes_plain(*args)[3]
        _equal([ln.ed_raw, ln.band_short, ln.overflow],
               list(tstep.lanes_plain(*args)[:3]))
    _equal(got, tstep.gact_setup_plain(lens, 1))


@pytest.mark.cuda
def test_raw_step_launches_the_glue_kernels_on_card(tmp_path):
    """A uniform chunk through raw_map_step on the card: the bytes equal
    the CPU's; each of the four kernels launched once, no plain version
    called on the card."""
    _card()
    rng = np.random.default_rng(9)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 20000))
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(">a\n" + genome[:12000] + "\n>b\n" + genome[12000:] + "\n")
    params = Params(hlen=6, seed_len=20, thres=300)
    build_index(fa, params, verbose=False, device=None)
    reads = []
    for i in range(30):
        p = int(rng.integers(0, len(genome) - 200))
        s = genome[p:p + 200]
        if i % 2:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append((f"r{i}", s, None))
    out = {}
    for dev in ("cpu", "cuda"):
        idx, meta, mta = load_device_index(fa, dev, verbose=False)
        tm = TorchMapper(idx, meta, mta, params, chunk_b=32, device=dev)
        L, prepped = tm._prepare_chunk(reads)
        _, raw, rc, lens, limits = prepped[0]
        assert rc is None                       # one length: raw bytes
        cfg = tm._step_for(L)
        args = [torch.from_numpy(a).to(dev) for a in (raw, lens, limits)]
        if dev == "cuda":
            tpipe.raw_map_step(cfg, idx, *args)    # builds, warms up
            for f in WRAPPERS:
                f.launches = 0
            for f in PLAINS:
                f.cuda_calls = 0
        out[dev] = tpipe.raw_map_step(cfg, idx, *args)
    torch.cuda.synchronize()
    for k in ("blob", "ops_tail"):
        assert torch.equal(out["cuda"][k].cpu(), out["cpu"][k]), k
    assert [f.launches for f in WRAPPERS] == [1, 1, 1, 1]
    assert [f.cuda_calls for f in PLAINS] == [0, 0, 0, 0]
    meta = out["cpu"]["blob"][:, :32].contiguous().view(torch.int32)
    assert int(meta[:30, 1].sum()) >= 25 and int(meta[:30, 3].sum()) > 0
