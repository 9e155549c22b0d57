"""The device read encode of the port (pipeline.raw_map_step; the JAX
mapper's raw variant) against the host encode and the JAX raw step: a
uniform chunk ships raw ASCII and is encoded and reverse-complemented on
the device.  Upper and lower case, N and junk bytes
(tests/test_raw_input.py's cases) give the host encode's records and the
JAX raw step's bytes; a ragged chunk takes the host encode.  Exact."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import sample_reads, write_fasta
from _torch_parity import build_both
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.models.mapper import TPUMapper
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper

torch.set_num_threads(1)
HLEN = 9


@pytest.fixture(scope="module")
def g120(tmp_path_factory):
    rng = np.random.default_rng(41)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 120_000))
    fa = str(tmp_path_factory.mktemp("torch_raw") / "raw.fa")
    write_fasta(fa, [("chr1", genome)])
    d = build_both(fa, HLEN)
    d["genome"] = genome
    d["params"] = Params(hlen=HLEN)
    return d


def _junk_reads(rng, genome, n, L):
    """tests/test_raw_input.py's uniform chunk: lowercase runs, N runs and
    a junk byte."""
    reads = []
    for i, (_, s, *_) in enumerate(sample_reads(rng, genome, n, L,
                                                error_rate=0.04)):
        s = list(s)
        if i % 3 == 0:
            s[10:60] = [c.lower() for c in s[10:60]]
        if i % 4 == 0:
            s[100:108] = "N" * 8
        if i % 7 == 0:
            s[200] = "x"
        reads.append((f"r{i}", "".join(s), "I" * L))
    return reads


def test_encode_raw_matches_host_table():
    """Every byte value, in reads shorter than the bucket and a zero pad
    row, against the host encode's table (formats/fastx._encode_lut) and
    its front-aligned reverse complement."""
    from longreadmapper_tpu_torch.formats.fastx import _encode_lut
    allb = np.arange(256, dtype=np.uint8)
    raw = np.zeros((4, 256), np.uint8)
    for i in range(3):
        raw[i, :200] = np.roll(allb, 37 * i)[:200]
    codes, codes_rc = tpipe.encode_raw(torch.from_numpy(raw), 200)
    lut = _encode_lut().view(np.int8)
    comp = np.where(lut < 4, 3 - lut, lut)
    want_c = np.full((4, 256), 4, np.int8)
    want_rc = np.full((4, 256), 4, np.int8)
    want_c[:3, :200] = lut[raw[:3, :200]]
    want_rc[:3, :200] = comp[raw[:3, :200]][:, ::-1]
    assert codes.dtype == codes_rc.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(codes_rc.numpy(), want_rc)


def test_raw_step_matches_jax_raw_step_and_host_encode(g120):
    rng = np.random.default_rng(7)
    reads = _junk_reads(rng, g120["genome"], 30, 500)
    B, L = 32, 512
    params = g120["params"]
    tm = TorchMapper(g120["tidx"], g120["tmeta"], g120["mta"], params,
                     chunk_b=B, device="cpu")
    raw, none, lens, limits = tm._pack_raw(reads, L, B)
    assert none is None and raw.dtype == np.uint8
    jc = jpipe.MapperConfig.from_params(params, g120["meta"], B, L)
    want = jpipe.make_map_step(replace(jc, raw_input=True))(
        g120["idx"], jnp.asarray(raw), jnp.asarray(lens),
        jnp.asarray(limits))
    tc = tpipe.MapperConfig.from_params(params, g120["tmeta"], B, L)
    got = tpipe.raw_map_step(tc, g120["tidx"], torch.from_numpy(raw),
                             torch.from_numpy(lens),
                             torch.from_numpy(limits), 500)
    host = tpipe.map_step(tc, g120["tidx"], *(
        torch.from_numpy(a) for a in tm._pack_reads(reads, L, B)))
    for k in ("blob", "ops_tail"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert torch.equal(got[k], host[k]), k


def test_raw_records_match_host_encode(g120, monkeypatch):
    """The uniform chunk (pad rows included: 30 reads in a chunk of 32)
    maps through the raw variant to the records of JAX's host encode."""
    rng = np.random.default_rng(8)
    reads = _junk_reads(rng, g120["genome"], 30, 500)
    tm = TorchMapper(g120["tidx"], g120["tmeta"], g120["mta"],
                     g120["params"], chunk_b=32, device="cpu")
    got = [r.to_sam() for r in tm.map_chunk(reads)]
    assert (tm.raw_chunks, tm.host_chunks) == (1, 0)
    monkeypatch.setenv("LRM_HOST_ENCODE", "1")
    jm = TPUMapper(g120["idx"], g120["meta"], g120["mta"], g120["params"],
                   chunk_b=32)
    want = [r.to_sam() for r in jm.map_chunk(reads)]
    assert not jm._raw_steps
    assert got == want
    assert sum("\t0\t" in r or "\t16\t" in r for r in got) >= 25


def test_ragged_chunk_takes_host_encode(g120):
    rng = np.random.default_rng(43)
    genome = g120["genome"]
    reads = []
    for i in range(12):
        p = int(rng.integers(0, len(genome) - 700))
        reads.append((f"r{i}", genome[p:p + 300 + 17 * i], None))
    tm = TorchMapper(g120["tidx"], g120["tmeta"], g120["mta"],
                     g120["params"], chunk_b=16, device="cpu")
    jm = TPUMapper(g120["idx"], g120["meta"], g120["mta"], g120["params"],
                   chunk_b=16)
    got = list(tm.map_stream_sam(iter([reads])))
    assert (tm.raw_chunks, tm.host_chunks) == (0, 1)
    assert got == list(jm.map_stream_sam(iter([reads])))
    assert got[0][2] == 12
