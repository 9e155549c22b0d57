"""The port's slice as a whole, on the CPU, against the JAX package and the
numpy oracle: TorchMapper records against the oracle (tests/test_e2e.py's
`_compare`), TorchMapper SAM text against TPUMapper's (incl. the overflow
retry tier), the port's `cli index` artifacts and devidx cache against the
JAX CLI's, the port's `cli map` SAM against the JAX CLI's, and a fresh
process that maps through the port without ever loading JAX."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import sample_reads, write_fasta, write_fastq
from _torch_parity import HLEN, build_both, e2e_fixture
from test_e2e import _compare
from longreadmapper_tpu.models.mapper import TPUMapper
from longreadmapper_tpu.oracle.refpipe import OracleMapper
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.models.mapper import TorchMapper

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = e2e_fixture(tmp_path_factory.mktemp("torch_e2e"))
    params = Params(hlen=HLEN, seed_len=20, thres=300, batch_size=64)
    d["params"] = params
    d["mapper"] = TorchMapper(d["tidx"], d["tmeta"], d["mta"], params,
                              chunk_b=16, device="cpu")
    d["oracle"] = OracleMapper(d["fmi"], d["kl"], HLEN, d["cat"], d["mta"],
                               params)
    return d


def _fqreads(reads):
    return [(n, s, "I" * len(s)) for n, s, *_ in reads]


@pytest.mark.parametrize("case", ["perfect", "noisy", "chrB_and_junk",
                                  "variable_length"])
def test_torch_mapper_matches_oracle(pipe, case):
    rng = np.random.default_rng(["perfect", "noisy", "chrB_and_junk",
                                 "variable_length"].index(case) + 1)
    if case == "perfect":
        reads = sample_reads(rng, pipe["chrA"], 12, 150, error_rate=0.0)
    elif case == "noisy":
        reads = sample_reads(rng, pipe["chrA"], 12, 200, error_rate=0.03)
    elif case == "chrB_and_junk":
        reads = sample_reads(rng, pipe["chrB"], 6, 150, error_rate=0.02) + [
            (f"junk{i}", "".join("ACGT"[c] for c in rng.integers(0, 4, 150)),
             None, 0) for i in range(4)]
    else:
        reads = sample_reads(rng, pipe["chrA"], 4, 80, error_rate=0.01) + \
            sample_reads(rng, pipe["chrA"], 4, 230, error_rate=0.01)
    recs = _compare(pipe["mapper"], pipe["oracle"], reads)
    if case == "perfect":
        assert sum(r.valid for r in recs) >= 10
        for (name, seq, pos, strand), rec in zip(reads, recs):
            if rec.valid:
                assert (rec.rname, rec.off, rec.cigar) == ("chrA", pos,
                                                           "150M")


def _sam_both(d, params, reads, chunk_b):
    jm = TPUMapper(d["idx"], d["meta"], d["mta"], params, chunk_b=chunk_b)
    tm = TorchMapper(d["tidx"], d["tmeta"], d["mta"], params,
                     chunk_b=chunk_b, device="cpu")
    chunks = [reads[s:s + chunk_b] for s in range(0, len(reads), chunk_b)]
    want = list(jm.map_stream_sam(iter(chunks)))
    got = list(tm.map_stream_sam(iter(chunks)))
    return jm, tm, want, got


def test_torch_sam_matches_tpu_mapper(pipe):
    rng = np.random.default_rng(44)
    reads = _fqreads(
        sample_reads(rng, pipe["chrA"], 20, 200, error_rate=0.04)
        + sample_reads(rng, pipe["chrB"], 12, 140, error_rate=0.02)
        + sample_reads(rng, pipe["chrA"], 8, 250, error_rate=0.0))
    jm, tm, want, got = _sam_both(pipe, pipe["params"], reads, 16)
    assert len(got) == 3
    assert got == want
    assert (tm.retried_reads, tm.overflow_reads) == (jm.retried_reads,
                                                     jm.overflow_reads)


def test_torch_map_stream_matches_tpu_mapper(pipe):
    """map_stream yields each chunk's MapRecords: field for field JAX's,
    chunk by chunk (4 chunks, so the depth-3 queue fills and drains), and
    the same records as map_stream_sam's text."""
    from dataclasses import astuple
    rng = np.random.default_rng(45)
    reads = _fqreads(
        sample_reads(rng, pipe["chrA"], 24, 200, error_rate=0.04)
        + sample_reads(rng, pipe["chrB"], 12, 140, error_rate=0.02)
        + [(f"junk{i}", "".join("ACGT"[c] for c in rng.integers(0, 4, 150)),
            None, 0) for i in range(4)])
    chunks = [reads[s:s + 12] for s in range(0, len(reads), 12)]
    jm = TPUMapper(pipe["idx"], pipe["meta"], pipe["mta"], pipe["params"],
                   chunk_b=12)
    tm = TorchMapper(pipe["tidx"], pipe["tmeta"], pipe["mta"],
                     pipe["params"], chunk_b=12, device="cpu")
    want = [[astuple(r) for r in c] for c in jm.map_stream(iter(chunks))]
    got = [[astuple(r) for r in c] for c in tm.map_stream(iter(chunks))]
    assert [len(c) for c in got] == [12, 12, 12, 4]
    assert got == want
    assert sum(r[-1] for c in got for r in c) >= 32
    sam = "".join(t for t, _, _ in tm.map_stream_sam(iter(chunks)))
    recs = [r for c in tm.map_stream(iter(chunks)) for r in c]
    assert sam == "".join(r.to_sam() for r in recs)


def test_torch_sam_matches_tpu_mapper_retry_tier(tmp_path):
    """Reads inside a tandem repeat overflow the compact vote slots: both
    mappers re-run them through the exact-slots tier, identically."""
    rng = np.random.default_rng(5)
    rand = lambda k: "".join("ACGT"[c] for c in rng.integers(0, 4, k))
    motif = rand(60)
    genome = rand(6000) + motif * 40 + rand(6000)
    fa = str(tmp_path / "rep.fa")
    write_fasta(fa, [("rep", genome)])
    d = build_both(fa, HLEN)
    params = Params(hlen=HLEN)
    reads = _fqreads(sample_reads(rng, genome[5000:9400], 12, 200,
                                  error_rate=0.02))
    jm, tm, want, got = _sam_both(d, params, reads, 16)
    assert got == want
    assert tm.retried_reads == jm.retried_reads > 0


def _artifacts(fa):
    names = [fa + ext for ext in (".mta", ".cat", ".cat.sa5", ".cat.mfi",
                                  ".cat.lch")]
    dd = fa + ".cat.devidx"
    names += [os.path.join(dd, f) for f in sorted(os.listdir(dd))]
    return {os.path.relpath(p, os.path.dirname(fa)): open(p, "rb").read()
            for p in names}


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """The same FASTA indexed by the JAX CLI (in `jax/`) and by the port's
    CLI (in `torch/`), plus a FASTQ of reads."""
    from longreadmapper_tpu import cli as jcli
    from longreadmapper_tpu_torch import cli as tcli
    from conftest import make_genome
    rng = np.random.default_rng(33)
    genome = make_genome(rng, 20000)
    root = tmp_path_factory.mktemp("torch_cli")
    out = {}
    for name, main, extra in (("jax", jcli.main, ["--host-only"]),
                              ("torch", tcli.main, ["--device", "cpu"])):
        os.makedirs(root / name)
        fa = str(root / name / "ref.fa")
        write_fasta(fa, [("c1", genome[:12000]), ("c2", genome[12000:])])
        assert main(["index", fa, "--hlen", str(HLEN), "--quiet"] + extra) \
            == 0
        out[name] = fa
    reads = sample_reads(rng, genome[:12000], 10, 200, error_rate=0.03) + \
        sample_reads(rng, genome[12000:], 6, 150, error_rate=0.02)
    fq = str(root / "reads.fq")
    write_fastq(fq, reads)
    out["fq"] = fq
    return out


def test_cli_index_artifacts_match_jax(cli_dirs):
    a = _artifacts(cli_dirs["jax"])
    b = _artifacts(cli_dirs["torch"])
    assert sorted(a) == sorted(b)
    assert len(a) >= 5 + 8                   # 5 artifacts, arrays, meta
    for k in a:
        assert a[k] == b[k], k


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("index_by", ["torch", "jax"])
def test_cli_map_sam_matches_jax(cli_dirs, index_by):
    """`map --rg-id 0` SAM of the port equals the JAX CLI's, on the port's
    own index and on the devidx cache the JAX CLI wrote."""
    from longreadmapper_tpu import cli as jcli
    from longreadmapper_tpu_torch import cli as tcli
    args = [cli_dirs["fq"], "1000", "20", "300", "--chunk-b", "16",
            "--rg-id", "0", "--quiet"]
    want = _run_cli(jcli.main, ["map", cli_dirs["jax"]] + args)
    got = _run_cli(tcli.main, ["map", cli_dirs[index_by]] + args
                   + ["--device", "cpu"])
    assert got.count("\n") == 16 + 4         # @SQ x2, @RG, @PG + records
    assert got == want


def test_accidx_script_artifacts_match_jax(cli_dirs, tmp_path,
                                           monkeypatch):
    """`accidx-torch ref.fa` (cli.accidx_main, the reference's accidx argv)
    writes the JAX CLI's artifacts and devidx cache byte for byte."""
    from longreadmapper_tpu_torch import cli as tcli
    fa = str(tmp_path / "ref.fa")
    with open(cli_dirs["jax"]) as f, open(fa, "w") as o:
        o.write(f.read())
    monkeypatch.setattr(sys, "argv", ["accidx-torch", fa, "--hlen",
                                      str(HLEN), "--device", "cpu",
                                      "--quiet"])
    assert tcli.accidx_main() == 0
    want, got = _artifacts(cli_dirs["jax"]), _artifacts(fa)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("params_file", [False, True])
def test_accaln_script_sam_matches_jax(cli_dirs, tmp_path, monkeypatch,
                                       params_file):
    """`accaln-torch ref.fa reads.fq [batch seed thres]`
    (cli.accaln_main) prints the SAM of the JAX package's `accaln` with the
    same arguments and --rg-id; without the three numbers both read them
    from a `params` file in the working directory."""
    from longreadmapper_tpu import cli as jcli
    from longreadmapper_tpu_torch import cli as tcli
    nums = ["1000", "20", "250"]
    if params_file:
        monkeypatch.chdir(tmp_path)
        (tmp_path / "params").write_text(" ".join(nums) + "\n")
        nums = []
    args = [cli_dirs["fq"]] + nums + ["--chunk-b", "16", "--rg-id", "0",
                                      "--quiet"]
    out = {}
    for name, main, extra in (("jax", jcli.accaln_main, []),
                              ("torch", tcli.accaln_main,
                               ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", [f"accaln-{name}",
                                          cli_dirs[name]] + args + extra)
        out[name] = _run_cli(lambda argv: main(), None)
    assert out["torch"].count("\n") == 16 + 4
    assert out["torch"] == out["jax"]


def test_run_mapping_logs_phase_times_and_retries(cli_dirs):
    """The verbose log of `map` ends with the mapper's host-phase seconds
    (JSON) and its retry counters."""
    import json
    from longreadmapper_tpu_torch import cli as tcli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _run_cli(tcli.main, ["map", cli_dirs["torch"], cli_dirs["fq"], "1000",
                             "20", "300", "--chunk-b", "16", "--rg-id", "0",
                             "--device", "cpu"])
    lines = err.getvalue().splitlines()
    phase = [l.split("phase_s ", 1)[1] for l in lines if "phase_s " in l]
    assert len(phase) == 1
    phase_s = json.loads(phase[0])
    assert sorted(phase_s) == ["assemble", "dispatch", "fetch", "prepare"]
    assert all(v >= 0 for v in phase_s.values())
    assert sum("retried reads 0, overflow reads" in l for l in lines) == 1


def test_stage_times_cover_every_stage(cli_dirs):
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches
    from longreadmapper_tpu_torch.runtime.stages import stage_times
    reads = next(iter(load_read_batches(cli_dirs["fq"], 16,
                                        background=False)))
    st = stage_times(cli_dirs["torch"], reads, chunk_b=8, device="cpu")
    assert st["timed_chunks"] == 1 and (st["B"], st["L"]) == (8, 256)
    assert list(st["stage_ms"]) == ["seed_tables", "narrow", "vote_rows",
                                    "accept", "locate_window", "band_dp",
                                    "walk", "pack"]
    assert st["seed_vote_ms"] == sum(st["stage_ms"][k] for k in (
        "seed_tables", "narrow", "vote_rows", "accept"))
    assert all(v >= 0 for v in st["stage_ms"].values()) and st["step_ms"] > 0
    assert st["trace"] is None                # traced on CUDA only
    with pytest.raises(ValueError):
        stage_times(cli_dirs["torch"], reads[:8], chunk_b=8, device="cpu")


def test_port_maps_without_loading_jax(tmp_path):
    rng = np.random.default_rng(9)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 6000))
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("g", genome)])
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, sample_reads(rng, genome, 4, 150, error_rate=0.02))
    code = f"""
import io, sys
from longreadmapper_tpu.utils.config import Params
from longreadmapper_tpu_torch.runtime.accidx import build_index
from longreadmapper_tpu_torch.runtime.accaln import run_mapping
build_index({fa!r}, Params(hlen=5), verbose=False, device="cpu")
buf = io.StringIO()
valid, total = run_mapping({fa!r}, {fq!r}, Params(), buf, verbose=False,
                           chunk_b=8, device="cpu")
assert total == 4 and valid >= 3, (valid, total)
print("JAX_LOADED", "jax" in sys.modules)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "JAX_LOADED False" in r.stdout, r.stdout


def test_device_cuda_refused_without_card():
    from longreadmapper_tpu_torch.device import pick_device
    if torch.cuda.is_available():
        assert pick_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            pick_device("cuda")
    assert pick_device("cpu").type == "cpu"


def test_outside_slice_raises(pipe, tmp_path, monkeypatch):
    from dataclasses import replace
    from longreadmapper_tpu_torch.index import sa_external
    from longreadmapper_tpu_torch.mapping.pipeline import MapperConfig
    from longreadmapper_tpu_torch import cli as tcli
    # long buckets and the slim / pos64 layouts are in the slice now
    assert MapperConfig.from_params(pipe["params"], pipe["tmeta"], 16,
                                    3072).L == 3072
    cfg = MapperConfig.from_params(
        pipe["params"], replace(pipe["tmeta"], slim=True,
                                pos_dtype="int64"), 16, 256)
    assert (cfg.slim, cfg.pos64, cfg.meta_words) == (True, True, 10)
    # `warmup` is in the slice (A11)
    assert tcli.main(["warmup", pipe["fa"], "--lengths", "256",
                      "--chunk-b", "16", "--device", "cpu", "--quiet"]) == 0
    # `index --ram-gb` is in the slice: it reaches the external build with
    # the budget in bytes (tests/test_torch_sa.py checks what it builds)
    class Reached(Exception):
        pass

    def external(prefix, ram_bytes):
        raise Reached(prefix, ram_bytes)

    monkeypatch.setattr(sa_external, "sa_build_external", external)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("c", pipe["chrA"][:3000])])
    with pytest.raises(Reached) as hit:
        tcli.main(["index", fa, "--ram-gb", "0.00001", "--device", "cpu",
                   "--quiet"])
    assert hit.value.args == (fa + ".cat", int(0.00001 * (1 << 30)))


def test_warmup_runs_every_step_variant(pipe, monkeypatch):
    """warmup([256]) runs bucket 256's host-encoded, raw and exact-slots
    retry variants once each (tests/test_cli.py's JAX counterpart checks
    that they were compiled), moves no counter, and a later map gives the
    SAM of a mapper that never warmed up."""
    from longreadmapper_tpu_torch.models import mapper as tmapper
    seen = []
    host_step, raw_step = tmapper.map_step, tmapper.raw_map_step

    def host(cfg, *a, **k):
        seen.append(("host", cfg))
        return host_step(cfg, *a, **k)

    def raw(cfg, *a, **k):
        seen.append(("raw", cfg))
        return raw_step(cfg, *a, **k)

    monkeypatch.setattr(tmapper, "map_step", host)
    monkeypatch.setattr(tmapper, "raw_map_step", raw)
    new = lambda: TorchMapper(pipe["tidx"], pipe["tmeta"], pipe["mta"],
                              pipe["params"], chunk_b=8, device="cpu")
    tm = new()
    assert tm.warmup([200, 256]) > 0
    cfg, retry = tm._step_for(256), tm._retry_step_for(256)
    assert retry.exact_slots and not cfg.exact_slots
    assert seen == [("host", cfg), ("raw", cfg), ("host", retry)]
    assert list(tm._cfgs) == list(tm._retry_cfgs) == [256]
    assert (tm.raw_chunks, tm.host_chunks, tm.retried_reads,
            tm.overflow_reads, tm.retried_sat_chunks) == (0, 0, 0, 0, 0)
    assert set(tm.phase_s.values()) == {0.0}
    reads = _fqreads(sample_reads(np.random.default_rng(3), pipe["chrA"],
                                  12, 200, error_rate=0.02))
    chunks = [reads[:8], reads[8:]]
    got = list(tm.map_stream_sam(iter(chunks)))
    want = list(new().map_stream_sam(iter(chunks)))
    assert got == want and sum(v for _, _, v in got) >= 10
