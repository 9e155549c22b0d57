"""The genome-scale index layouts of the port against the JAX package: the
40-bit split-hi positions (pos64: int32 low words beside uint8 high bytes,
int64 arithmetic, 10-word meta rows) and the slim layout (the SA without
its context column, each verify window rebuilt from a text_pair gather).

  - the host assembly, array by array, in (int32 | forced int64) x
    (full | slim);
  - slim SAM against JAX slim SAM and the port's full SAM;
  - forced pos64 SAM (short reads, the gact path, slim + pos64) against
    tests/_pos64_worker.py, which runs JAX in x64 mode in its own process;
  - the shared devidx cache's rules, across both packages;
  - top2_votes / top2_small_histo on int64 keys;
  - the slim verify window against _pack_ctx_words;
  - a pos64 retry splice (vote overflow, bit 0) at 10 meta words.
Every comparison is exact."""

import io
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_genome, sample_reads, write_fasta, write_fastq
from _torch_parity import (assert_sam_matches_jax_or_oracle, build_both,
                           jax_flagged_reads)
from longreadmapper_tpu.index import device as jdevice
from longreadmapper_tpu.mapping import pipeline as jpipe
from longreadmapper_tpu.models.mapper import TPUMapper
from longreadmapper_tpu.ops import vote as jvote
from longreadmapper_tpu.oracle.refpipe import OracleMapper
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.formats.sam import sam_header
from longreadmapper_tpu_torch.index import device as tdevice
from longreadmapper_tpu_torch.mapping import pipeline as tpipe
from longreadmapper_tpu_torch.models.mapper import TorchMapper
from longreadmapper_tpu_torch.ops import seed_vote as tsv
from longreadmapper_tpu_torch.ops import vote as tvote
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.runtime.reads import chunks, load_read_batches

torch.set_num_threads(1)
HLEN = 6
WORKER = os.path.join(os.path.dirname(__file__), "_pos64_worker.py")


@pytest.fixture(scope="module")
def g24(tmp_path_factory):
    """tests/test_pos64.py's genome (24 kb, two contigs, hlen 6) indexed
    for both packages, and its 32 reads of 150 bp at 3%."""
    rng = np.random.default_rng(17)
    genome = make_genome(rng, 24000)
    fa = str(tmp_path_factory.mktemp("torch_layouts") / "ref.fa")
    write_fasta(fa, [("c1", genome[:11000]), ("c2", genome[11000:])])
    d = build_both(fa, HLEN)
    reads = sample_reads(rng, genome, 32, 150, error_rate=0.03)
    d["fq"] = fa + ".fq"
    write_fastq(d["fq"], [(n, s, None) for n, s, *_ in reads])
    d["genome"] = genome
    return d


# ------------------------------------------------------------ host arrays

@pytest.mark.parametrize("force", [None, "int64"])
@pytest.mark.parametrize("slim", [False, True])
def test_assemble_host_arrays_match_jax(g24, force, slim):
    args = (g24["fmi"], g24["kl"], HLEN, g24["cat"], g24["mta"])
    want, wmeta = jdevice._assemble_host_arrays(
        *args, force_pos_dtype=force, slim=slim)
    got, gmeta = tdevice._assemble_host_arrays(
        *args, force_pos_dtype=force, slim=slim)
    assert (gmeta.pos_dtype, gmeta.slim) == (force or "int32", slim)
    assert vars(gmeta) == vars(wmeta)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got["sa_hi"] is None) == (force is None)
    assert (got["text_pair"] is None) == (not slim)
    assert got["c4"].dtype == got["mta_start"].dtype == np.dtype(
        force or "int32")


# ------------------------------------------------------------------ slim

def test_slim_sam_matches_jax_slim_and_port_full(tmp_path):
    """tests/test_slim_index.py's case: 250 kb, hlen 10, 48 reads of 600
    bp at 5%."""
    rng = np.random.default_rng(17)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 250_000))
    fa = str(tmp_path / "slim.fa")
    write_fasta(fa, [("chr1", genome)])
    d = build_both(fa, 10)
    reads = [(f"r{i}", s, "I" * len(s)) for i, (_, s, *_) in enumerate(
        sample_reads(rng, genome, 48, 600, error_rate=0.05))]
    params = Params(hlen=10)
    args = (d["fmi"], d["kl"], 10, d["cat"], d["mta"])
    jidx, jmeta = jdevice.build_device_index(*args, slim=True)
    tidx, tmeta = tdevice.build_device_index(*args, "cpu", slim=True)
    assert tidx.sa_ctx.ndim == 1 and tidx.text_pair is not None

    def sam(m):
        return list(m.map_stream_sam(iter([reads])))

    want = sam(TPUMapper(jidx, jmeta, d["mta"], params, chunk_b=48))
    got = sam(TorchMapper(tidx, tmeta, d["mta"], params, chunk_b=48,
                          device="cpu"))
    full = sam(TorchMapper(d["tidx"], d["tmeta"], d["mta"], params,
                           chunk_b=48, device="cpu"))
    assert got == want == full
    assert got[0][2] >= 40                         # valid records


# ----------------------------------------------------------------- pos64

def _worker_sam(fa, fq, batch, slim=False, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(env_extra or {})
    args = [sys.executable, WORKER, fa, fq, str(batch), "20", "300"]
    r = subprocess.run(args + (["slim"] if slim else []),
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "POS64_OK" in r.stderr
    return r.stdout


def _port_sam(fa, fq, batch, slim=False, gact_bucket=0, **load):
    """SAM of the port's TorchMapper (chunk 16, as the worker's) over the
    index loaded with `load`; `gact_bucket` forces the gact path there as
    LRM_MID_DIRS_BUDGET=0 does in JAX."""
    idx, meta, mta = tdevice.load_device_index(fa, "cpu", verbose=False,
                                               slim=slim, **load)
    params = Params(hlen=meta.hlen, seed_len=20, thres=300,
                    batch_size=batch)
    tm = TorchMapper(idx, meta, mta, params, chunk_b=16, device="cpu")
    if gact_bucket:
        tm._cfgs[gact_bucket] = replace(tm._step_for(gact_bucket),
                                        mid_dirs_budget=0)
        assert tm._step_for(gact_bucket).use_gact
    out = io.StringIO()
    out.write(sam_header(mta, 0))
    for b in load_read_batches(fq, params.batch_size, background=False):
        for text, _, _ in tm.map_stream_sam(chunks(b, tm.B)):
            out.write(text)
    return out.getvalue(), meta, tm


@pytest.mark.parametrize("case", ["short", "gact", "slim"])
def test_pos64_sam_matches_jax_worker(g24, tmp_path, case):
    """Forced pos64 against tests/_pos64_worker.py: the 32 short reads
    (full and slim) and four 2600 bp reads on the gact path
    (tests/test_pos64.py:97-135)."""
    fa, fq, batch, env, bucket = g24["fa"], g24["fq"], 64, None, 0
    if case == "gact":
        rng = np.random.default_rng(99)
        genome = g24["genome"]
        reads = []
        for i in range(4):
            p = int(rng.integers(0, 11000 - 2600))
            s = list(genome[p:p + 2600])
            for _ in range(50):
                s[int(rng.integers(0, 2600))] = "ACGT"[int(rng.integers(0,
                                                                        4))]
            reads.append((f"lr{i}", "".join(s), None))
        fq = str(tmp_path / "long.fq")
        write_fastq(fq, reads)
        batch, env, bucket = 4, {"LRM_MID_DIRS_BUDGET": "0"}, 3072
    slim = case == "slim"
    want = _worker_sam(fa, fq, batch, slim=slim, env_extra=env)
    got, meta, tm = _port_sam(fa, fq, batch, slim=slim, gact_bucket=bucket,
                              force_pos_dtype="int64")
    assert (meta.pos_dtype, meta.slim) == ("int64", slim)
    assert tm._step_for(3072 if bucket else 256).meta_words == 10
    assert got == want
    full, _, _ = _port_sam(fa, fq, batch, gact_bucket=bucket)
    assert got == full
    n_valid = sum(1 for line in got.splitlines()
                  if line[0] != "@" and line.split("\t")[1] in ("0", "16"))
    assert n_valid >= (4 if bucket else 28)


def test_pos64_retry_splice_decodes_10_meta_words(tmp_path):
    """Reads inside a tandem repeat flag vote overflow (bit 0) and re-run
    through the exact tier; under pos64 the spliced rows are 10 words wide
    and the SAM equals the int32 layout's and TPUMapper's (the oracle's
    for a read JAX leaves flagged: its vote overflows JAX's exact tier,
    and the port's wide vote class step maps it)."""
    rng = np.random.default_rng(5)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    motif = rand(60)
    genome = rand(6000) + motif * 40 + rand(6000)
    fa = str(tmp_path / "rep.fa")
    write_fasta(fa, [("rep", genome)])
    d = build_both(fa, HLEN)
    params = Params(hlen=HLEN)
    reads = [(n, s, "I" * len(s)) for n, s, *_ in sample_reads(
        rng, genome[5000:9400], 12, 200, error_rate=0.02)]
    idx, meta, mta = tdevice.load_device_index(fa, "cpu", verbose=False,
                                               force_pos_dtype="int64")
    t64 = TorchMapper(idx, meta, mta, params, chunk_b=16, device="cpu")
    t32 = TorchMapper(d["tidx"], d["tmeta"], mta, params, chunk_b=16,
                      device="cpu")
    jm = TPUMapper(d["idx"], d["meta"], mta, params, chunk_b=16)
    flagged = jax_flagged_reads(jm)
    got, w32, want = (list(m.map_stream_sam(iter([reads])))
                      for m in (t64, t32, jm))
    assert got == w32
    oracle = OracleMapper(d["fmi"], d["kl"], HLEN, d["cat"], d["mta"],
                          params)
    assert assert_sam_matches_jax_or_oracle(
        got[0][0], want[0][0], flagged, oracle) == len(flagged)
    assert t64.retried_reads == jm.retried_reads > 0
    assert t64.wide_vote_reads > 0 and t64.wide_vote_unresolved == 0
    assert t64._retry_step_for(256).meta_words == 10


# ----------------------------------------------------------------- cache

def _cache_meta(fa):
    with open(fa + ".cat.devidx/meta.json") as f:
        return f.read()


def test_cache_jax_full_serves_port_slim(tmp_path, monkeypatch):
    """A full cache the JAX package wrote serves the port's slim load by
    derivation (no assembly) and stays as it was."""
    from longreadmapper_tpu.runtime.accidx import build_index as jbuild
    rng = np.random.default_rng(2)
    fa = str(tmp_path / "j.fa")
    write_fasta(fa, [("c", make_genome(rng, 30000))])
    jbuild(fa, Params(hlen=HLEN), use_device=False, verbose=False)
    before = _cache_meta(fa)
    direct, _, _ = tdevice.load_device_index(fa, "cpu", cache=False,
                                             verbose=False, slim=True)

    def no_assembly(*a, **k):
        raise AssertionError("the cache should have served this load")

    monkeypatch.setattr(tdevice, "_assemble_host_arrays", no_assembly)
    idx, meta, _ = tdevice.load_device_index(fa, "cpu", verbose=False,
                                             slim=True)
    assert meta.slim and idx.sa_ctx.ndim == 1
    for k in ("sa_ctx", "text_pair", "text_packed", "lch", "packed"):
        assert torch.equal(getattr(idx, k), getattr(direct, k)), k
    assert _cache_meta(fa) == before


def test_cache_port_written_jax_reads(tmp_path, monkeypatch):
    """The port's build writes the cache; the JAX package loads it full
    and slim without assembling, to the arrays it would build itself."""
    rng = np.random.default_rng(3)
    fa = str(tmp_path / "t.fa")
    write_fasta(fa, [("c", make_genome(rng, 30000, n_frac=0.01))])
    build_index(fa, Params(hlen=HLEN), verbose=False, device="cpu")
    direct, _, _ = jdevice.load_device_index(fa, cache=False, verbose=False)

    def no_assembly(*a, **k):
        raise AssertionError("the cache should have served this load")

    monkeypatch.setattr(jdevice, "_assemble_host_arrays", no_assembly)
    for slim in (False, True):
        idx, meta, _ = jdevice.load_device_index(fa, slim=slim,
                                                 verbose=False)
        assert meta.slim == slim and meta.pos_dtype == "int32"
        np.testing.assert_array_equal(
            np.asarray(idx.sa_ctx)[:meta.n],
            np.asarray(direct.sa_ctx)[:meta.n, 0] if slim
            else np.asarray(direct.sa_ctx)[:meta.n])
        np.testing.assert_array_equal(np.asarray(idx.lch),
                                      np.asarray(direct.lch))


def test_cache_forced_and_slim_write_rules(tmp_path):
    """A forced pos64 load writes no cache and is served by none; a slim
    load from the artifacts writes a slim cache, which serves no full
    load of either package: each rebuilds and writes the full one."""
    import shutil
    rng = np.random.default_rng(4)
    fa = str(tmp_path / "r.fa")
    write_fasta(fa, [("c", make_genome(rng, 30000))])
    build_index(fa, Params(hlen=HLEN), verbose=False, devidx=False,
                device="cpu")
    cache = fa + ".cat.devidx"
    _, meta, _ = tdevice.load_device_index(fa, "cpu", verbose=False,
                                           force_pos_dtype="int64")
    assert meta.pos_dtype == "int64" and not os.path.exists(cache)
    for load in (lambda: jdevice.load_device_index(fa, verbose=False),
                 lambda: tdevice.load_device_index(fa, "cpu",
                                                   verbose=False)):
        shutil.rmtree(cache, ignore_errors=True)
        _, meta, _ = tdevice.load_device_index(fa, "cpu", verbose=False,
                                               slim=True)
        slim_cache = _cache_meta(fa)
        assert meta.slim and '"slim": true' in slim_cache
        _, meta, _ = tdevice.load_device_index(fa, "cpu", verbose=False,
                                               force_pos_dtype="int64",
                                               slim=True)
        assert (meta.pos_dtype, meta.slim) == ("int64", True)
        assert _cache_meta(fa) == slim_cache
        idx, meta, _ = load()
        assert not meta.slim and np.asarray(idx.sa_ctx).ndim == 2
        assert '"slim": false' in _cache_meta(fa)


# ----------------------------------------------------------- int64 votes

def _votes(seed, B, V, lo, hi):
    rng = np.random.default_rng(seed)
    base = rng.integers(lo, hi, (B, 1))
    keys = base + rng.integers(-3 * 16, 3 * 16, (B, V))
    valid = rng.random((B, V)) < 0.7
    valid[0] = False                               # an empty row
    valid[1, :] = False
    valid[1, V // 2] = True                        # a single vote
    keys[2] = -5                                   # one negative key
    return keys.astype(np.int64), valid


def _run(fn, keys, valid):
    return [x.numpy() for x in fn(torch.from_numpy(keys),
                                  torch.from_numpy(valid))]


@pytest.mark.parametrize("fn", ["top2_votes", "top2_small_histo"])
@pytest.mark.parametrize("seed,B,V", [(0, 8, 80), (1, 16, 21), (2, 5, 7)])
def test_int64_votes_shift_and_match_int32(fn, seed, B, V):
    """int64 keys inside the int32 range give JAX's int32 results; a
    shift by a multiple of 16 (across 2^32 and 2^36) shifts key1 by the
    same amount and leaves both counts."""
    keys, valid = _votes(seed, B, V, -40, 1000)
    tfn, jfn = getattr(tvote, fn), getattr(jvote, fn)
    v1, key1, v2 = _run(tfn, keys, valid)
    assert key1.dtype == np.int64 and v1.dtype == np.int32
    want = jfn(jnp.asarray(keys.astype(np.int32)), jnp.asarray(valid))
    for g, w in zip((v1, key1, v2), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (v1[2:] > 0).any() and (key1 < 0).any()
    for shift in ((1 << 32) - 512, 1 << 32, 1 << 36, 3 * (1 << 36) + 16,
                  -(1 << 32)):
        s1, skey1, s2 = _run(tfn, keys + shift, valid)
        np.testing.assert_array_equal(s1, v1)
        np.testing.assert_array_equal(s2, v2)
        np.testing.assert_array_equal(skey1, np.where(v1 > 0, key1 + shift,
                                                      0))


def test_int64_votes_keep_tie_order_across_2_32():
    """Two equally voted buckets on either side of 2^32: the one inserted
    first wins, as the reference's stable scan."""
    base = (1 << 32) - 16
    keys = np.array([[base + 3, base + 16 + 1, base + 1, base + 16 + 5],
                     [base + 16 + 1, base + 3, base + 16 + 5, base + 1]],
                    np.int64)
    valid = np.ones_like(keys, bool)
    v1, key1, v2 = _run(tvote.top2_votes, keys, valid)
    np.testing.assert_array_equal(v1, [2, 2])
    np.testing.assert_array_equal(v2, [2, 2])
    np.testing.assert_array_equal(key1, [base + 1, base + 16 + 1])


# ------------------------------------------------------ slim verify window

@pytest.mark.parametrize("seed_len", [6, 12, 20, 22])
def test_ctx_window_matches_pack_ctx_words(g24, seed_len):
    """The slim window of every SA row (sa < 16, o == 0 and the last text
    word among them) equals the top `left` bases of the full layout's
    context word, and JAX's _ctx_window, in int32 and int64."""
    args = (g24["fmi"], g24["kl"], HLEN, g24["cat"], g24["mta"])
    full, _ = tdevice._assemble_host_arrays(*args)
    sidx, smeta = tdevice.build_device_index(*args, "cpu", slim=True)
    sa = full["sa_ctx"][:, 0]
    n = sa.shape[0]
    assert (sa < 16).sum() == 16 and ((sa - 16) % 16 == 0).any()
    assert (sa >= n - 17).any()
    params = Params(hlen=HLEN, seed_len=seed_len)
    cfg = tpipe.MapperConfig.from_params(params, smeta, 8, 256)
    left = cfg.left
    want = ((full["sa_ctx"][:, 1].astype(np.int64) & 0xFFFFFFFF)
            >> (2 * (16 - left)))
    real = sa >= left                 # the step verifies only these rows
    for dt in (torch.int32, torch.int64):
        got = tsv._ctx_window(cfg, sidx, torch.from_numpy(sa).to(dt))
        np.testing.assert_array_equal(got.numpy()[real], want[real])
    jidx, jmeta = jdevice.build_device_index(*args, slim=True)
    jcfg = jpipe.MapperConfig.from_params(params, jmeta, 8, 256)
    jwin = np.asarray(jpipe._ctx_window(jcfg, jidx, jnp.asarray(sa)))
    np.testing.assert_array_equal(
        tsv._ctx_window(cfg, sidx, torch.from_numpy(sa)).numpy(),
        jwin.astype(np.int64))
