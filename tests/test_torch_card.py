"""The port on the card against the port on the CPU, for the parts that
the smoke's main path does not reach alone: the lchash's device build, the
device read encode, the forced pos64 and slim layouts, the vote-overflow
tier (bit 0: reads inside a tandem repeat overflow the compact vote
slots) and the gact saturation tier (bit 1, forced on a submitted chunk
as tests/test_torch_long.py forces it on the CPU).  Every SAM is
byte-identical between the devices and every CIGAR is checked against the
genome.

Card-only: the tests skip where torch.cuda.is_available() is false, and
import no JAX, so they run where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from _torch_parity import cigar_check
from longreadmapper_tpu_torch.formats.lch import read_lch
from longreadmapper_tpu_torch.index.device import (DeviceIndex, bwt_arrays,
                                                   load_device_index)
from longreadmapper_tpu_torch.index.fmi import FMIndex
from longreadmapper_tpu_torch.index.lchash import lc_build_device
from longreadmapper_tpu_torch.mapping.pipeline import raw_map_step
from longreadmapper_tpu_torch.models.mapper import TorchMapper
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
                                         for a in (raw, lens, limits)), 500)
        outs[dev] = ({k: v.cpu() for k, v in step.items()},
                     [r.to_sam() for r in tm.map_chunk(reads)], tm)
    for k in ("blob", "ops_tail"):
        assert torch.equal(outs["cuda"][0][k], outs["cpu"][0][k]), k
    assert outs["cuda"][1] == outs["cpu"][1]
    assert outs["cuda"][2].raw_chunks == 1
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
        for cfg, _, _, out in pending:
            if out["event"] is not None:
                out["event"].synchronize()      # the D2H copy has landed
            mw = 4 * cfg.meta_words
            blob = out["blob"].numpy()           # pinned host memory
            meta_w = np.ascontiguousarray(blob[:, :mw]).view(np.int32)
            meta_w[:, -1] |= 2
            blob[:, :mw] = meta_w.view(np.int8)
        got = [r.to_sam() for r in tm.collect_chunk(pending)]
        assert got == base
        assert (tm.retried_sat_chunks, tm.overflow_reads) == (1, 0)
        texts[dev] = "".join(got)
    assert texts["cuda"] == texts["cpu"]
    _check_records(texts["cuda"], genome, 4, 4)
