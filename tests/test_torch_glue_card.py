"""The step glue's CUDA kernels (csrc/step.cu) on the card against their
plain versions (ops/step.py), bit for bit, on the CPU tests' inputs
(tests/_glue_inputs.py): encode_kernel on rows with garbage past the read;
locate_window_kernel on the edge tables (zero-length contigs, boundaries,
reads of length 0, int32 wrap near 2^31 - 1, an int64 table above 2^32),
at every sub-word offset, and over a text that stands for a row-sharded
one (two launches, the words gathered between them); lanes_kernel in both
modes; pack_kernel in int16 and int32 entries, pos64, the gact head and
the saturation bit, rows of 1 to 32 warps (the 50 kb row's 10,456
entries, and past 32 x 256); each also at B = 1 and B = 3, and with every
output allocated over memory filled with garbage (the kernel must write
every byte); then a whole raw step on the card, byte-equal to the CPU's, that
launched the four kernels and called no plain version.

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


def _run(wrapper, args, garbage: bool, launches: int = 1):
    """wrapper(*args) on the card, its outputs allocated over garbage
    bytes when `garbage`; checks its launch count."""
    n = wrapper.launches
    if garbage:
        empty = torch.empty

        def dirty(*a, **kw):
            t = empty(*a, **kw)
            t.view(-1).view(torch.uint8).fill_(0xA5)
            return t

        torch.empty = dirty
        try:
            got = wrapper(*args)
        finally:
            torch.empty = empty
    else:
        got = wrapper(*args)
    assert wrapper.launches == n + launches
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
@pytest.mark.parametrize("B,L,L0", [(1, 64, 37), (3, 128, 128),
                                    (2, 48, 0), (2048, 1024, 1000),
                                    (40, 50176, 50000)])
def test_encode_kernel_matches_plain_on_card(B, L, L0, garbage):
    _card()
    raw = torch.from_numpy(G.raw_case(np.random.default_rng(L0), B, L,
                                      L0)).cuda()
    got = _run(tstep.encode_raw, (raw, L0), garbage)
    _equal(got, tstep.encode_raw_plain(raw, L0))


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
    _card()
    w, lens, lim, found, ovf = G.lanes_case(np.random.default_rng(B), B, L)
    args = tuple(torch.from_numpy(x).cuda() for x in (w, lens, lim, found,
                                                      ovf)) + (64, narrow)
    _equal(_run(tstep.lanes, args, garbage), tstep.lanes_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("saturated", [None, True, False])
@pytest.mark.parametrize("B,R,eb,pos64,gact", [
    (1, 40, 2, False, False), (3, 3, 4, True, False), (9, 70, 2, True, True),
    (2048, 26, 2, False, False), (200, 300, 4, False, False),
    (40, 5000, 2, True, True), (3, 1, 2, False, False),
    (2, 10456, 2, True, True), (3, 8292, 4, False, False)])
def test_pack_kernel_matches_plain_on_card(B, R, eb, pos64, gact,
                                           saturated, garbage):
    _card()
    v = G.to_torch(G.pack_case(np.random.default_rng(R * eb), B, R, eb,
                               pos64), "cuda")
    c = G.cfg(B, 64, 1000, pos64=pos64, use_gact=gact, entry_bytes=eb)
    sat = None if saturated is None else torch.tensor(saturated).cuda()
    args = (c, v["best"], v["found"], v["gi"], v["strand"], v["off"],
            v["ed_raw"], v["limit"], v["band_short"], v["overflow"],
            v["runs"], sat)
    _equal(_run(tstep.pack, args, garbage), tstep.pack_plain(*args))


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
            tpipe.raw_map_step(cfg, idx, *args, 200)    # builds, warms up
            for f in WRAPPERS:
                f.launches = 0
            for f in PLAINS:
                f.cuda_calls = 0
        out[dev] = tpipe.raw_map_step(cfg, idx, *args, 200)
    torch.cuda.synchronize()
    for k in ("blob", "ops_tail"):
        assert torch.equal(out["cuda"][k].cpu(), out["cpu"][k]), k
    assert [f.launches for f in WRAPPERS] == [1, 1, 1, 1]
    assert [f.cuda_calls for f in PLAINS] == [0, 0, 0, 0]
    meta = out["cpu"]["blob"][:, :32].contiguous().view(torch.int32)
    assert int(meta[:30, 1].sum()) >= 25 and int(meta[:30, 3].sum()) > 0
