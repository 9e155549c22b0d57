"""The port's multi-process mapping (runtime/launch.run_distributed over
torch.distributed, parallel/) on the CPU against the JAX package's
run_distributed, run in this process on conftest's 8 virtual CPU devices.

The fixture is tests/test_dist.py's: a 20 kb genome, 32 reads of 150 bp,
hlen 6, chunks of 16.  The port runs at world sizes 1, 2 and 4, one Gloo
rank a process (tests/_torch_dist_worker.py, which imports only the
port): replicated, row-sharded over 'model' and row-sharded slim; a few
2.6 kb reads through the gact path; the gact saturation tier under a mesh
(where the port departs from JAX, ROADMAP.md section C).  Tolerance:
exact, byte for byte, and every rank's global (valid, total) equal to
JAX's.  Every subprocess has a timeout, and every process group one of
seconds, so a hung rank fails its test instead of stalling the suite."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import make_genome, sample_reads, write_fasta, write_fastq
from longreadmapper_tpu.formats.catmeta import create_meta
from longreadmapper_tpu.formats.lch import write_lch
from longreadmapper_tpu.index.fmi import FMIndex
from longreadmapper_tpu.index.lchash import lc_build_host
from longreadmapper_tpu.index.sa import sa_build
from longreadmapper_tpu.utils.config import Params

torch.set_num_threads(1)
HLEN = 6
CHUNK_B = 16
LONG_L = 3072                    # the 2.6 kb reads' bucket
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """tests/test_dist.py's artifacts and reads, plus 6 reads of 2.6 kb."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    rng = np.random.default_rng(91)
    genome = make_genome(rng, 20000)
    fa = str(tmp / "ref.fa")
    write_fasta(fa, [("chr1", genome)])
    params = Params(hlen=HLEN, seed_len=20, thres=300, batch_size=64)
    create_meta(fa, n_seed=params.n_seed)
    prefix = fa + ".cat"
    sa = sa_build(prefix)
    fmi = FMIndex.build(prefix, o_ratio=params.o_ratio,
                        csa_ratio=params.csa_ratio, sa=sa)
    fmi.write(prefix)
    write_lch(prefix + ".lch", HLEN, lc_build_host(fmi, HLEN))
    reads = sample_reads(rng, genome, 32, 150, error_rate=0.02)
    fq = str(tmp / "r.fq")
    write_fastq(fq, [(n, s, None) for n, s, *_ in reads])
    long_reads = sample_reads(np.random.default_rng(7), genome, 6, 2600,
                              error_rate=0.02)
    fq_long = str(tmp / "long.fq")
    write_fastq(fq_long, [(n, s, None) for n, s, *_ in long_reads])
    return dict(fa=fa, fq=fq, fq_long=fq_long, params=params, tmp=tmp,
                jax={})


def _jax_run(art, key, fq, **kw):
    """JAX's run_distributed over the 8 virtual devices (cached per
    `key`): its .part0 text and (valid, total)."""
    if key not in art["jax"]:
        from longreadmapper_tpu.runtime.launch import run_distributed
        prefix = str(art["tmp"] / f"jax_{key}.sam")
        vt = run_distributed(art["fa"], fq, art["params"], out_prefix=prefix,
                             rg_id=0, chunk_b=CHUNK_B, verbose=False, **kw)
        with open(prefix + ".part0") as f:
            art["jax"][key] = (f.read(), vt)
    return art["jax"][key]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world: int, cfg: dict, tmp, env_rendezvous: bool = False,
            timeout: float = RUN_TIMEOUT_S):
    """Start `world` worker ranks and wait for them: (rc, stdout, stderr)
    per rank.  The ranks meet over a FileStore in `tmp`, or, with
    env_rendezvous, over MASTER_ADDR/MASTER_PORT (a port the OS picked)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if env_rendezvous:
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world))
    else:
        store = tmp / f"store_{time.monotonic_ns()}"
        cfg = dict(cfg, store=str(store))
    procs = []
    for r in range(world):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if env_rendezvous \
            else env
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), json.dumps(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=e,
            text=True, cwd=str(tmp)))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _reports(outs, tag="WORKER_OK"):
    reps = []
    for rc, out, err in outs:
        assert rc == 0, (rc, out, err[-3000:])
        line = next(l for l in out.splitlines() if l.startswith(tag))
        reps.append(json.loads(line[len(tag) + 1:]))
    return reps


def _merge(prefix: str, n_data: int, part_rows: int) -> str:
    """tests/test_dist.py's stripe merge of `n_data` part files: record
    order is chunk-major, then data slice (part_rows // n_data rows of
    each chunk part a file)."""
    texts = []
    for k in range(n_data):
        with open(f"{prefix}.part{k}") as f:
            texts.append(f.read())
    header = "".join(l + "\n" for l in texts[0].splitlines()
                     if l.startswith("@"))
    recs = [[l + "\n" for l in t.splitlines() if not l.startswith("@")]
            for t in texts]
    share = part_rows // n_data
    merged = header
    for c in range(0, len(recs[0]), share):
        merged += "".join("".join(r[c:c + share]) for r in recs)
    return merged


def _map_cfg(art, prefix, **kw):
    return dict(mode="map", fa=art["fa"], fq=art["fq"], prefix=prefix,
                chunk_b=CHUNK_B, **kw)


def test_world1_replicated_equals_jax(art, tmp_path):
    """(a) One process forms a world-1 Gloo group through its own store:
    .part0 equals JAX's, and the group is gone afterwards."""
    import torch.distributed as dist
    from longreadmapper_tpu_torch.runtime.launch import run_distributed
    want, want_vt = _jax_run(art, "rep", art["fq"])
    prefix = str(tmp_path / "w1.sam")
    vt = run_distributed(art["fa"], art["fq"], art["params"],
                         out_prefix=prefix, rg_id=0, chunk_b=CHUNK_B,
                         verbose=False, device="cpu")
    assert vt == want_vt == (32, 32)
    with open(prefix + ".part0") as f:
        assert f.read() == want
    assert not os.path.exists(prefix + ".part1")
    assert not dist.is_initialized()


def test_two_ranks_replicated_equals_jax(art, tmp_path):
    """(b) Two ranks meet over MASTER_ADDR/MASTER_PORT (init_distributed's
    env:// path); the stripe-merged parts equal JAX's output and both ranks
    report JAX's global (valid, total)."""
    want, want_vt = _jax_run(art, "rep", art["fq"])
    prefix = str(tmp_path / "r2.sam")
    reps = _reports(_launch(2, _map_cfg(art, prefix), tmp_path,
                            env_rendezvous=True))
    assert [(r["valid"], r["total"]) for r in reps] == [want_vt] * 2
    assert _merge(prefix, 2, CHUNK_B) == want


@pytest.mark.parametrize("world,model,slim", [(2, 2, False), (4, 2, True)],
                         ids=["model2", "data2_model2_slim"])
def test_sharded_index_equals_jax(art, tmp_path, world, model, slim):
    """(c) Two ranks, the six gather tables row-sharded over model 2;
    (d) four ranks, data 2 x model 2, sharded slim.  Against JAX's
    shard_index_tables=True, model_shards=2 runs (slim for (d)).  Each
    rank holds only its row block of each table."""
    want, want_vt = _jax_run(art, f"shard_slim{slim}", art["fq"],
                             shard_index_tables=True, model_shards=2,
                             slim=slim)
    prefix = str(tmp_path / "s.sam")
    reps = _reports(_launch(world, _map_cfg(
        art, prefix, shard=True, model_shards=model, slim=slim), tmp_path))
    assert [(r["valid"], r["total"]) for r in reps] == [want_vt] * world
    n_data = world // model
    assert _merge(prefix, n_data, CHUNK_B) == want
    assert not os.path.exists(f"{prefix}.part{n_data}")
    names = {"sa_ctx", "lch", "text_packed"} | ({"text_pair"} if slim
                                                else set())
    for r in reps:
        assert set(r["tables"]) == names
        for name, (nbytes, shape) in r["tables"].items():
            row = int(np.prod(shape[1:], dtype=np.int64)) * (
                1 if name.endswith("_hi") else 4)
            assert nbytes == -(-shape[0] // model) * row, (name, nbytes)


def test_sharded_rows_gather_two_ranks(tmp_path):
    """(e) ShardedRows over two ranks against the plain gather of the whole
    table: at the shard edges, at the clamped last row and past it (zero),
    for int32 (negative words included), uint8 and (n, 2) rows; tables of
    odd length report their unpadded shape, and each rank holds
    ceil(n / 2) rows."""
    reps = _reports(_launch(2, dict(mode="rows"), tmp_path), "ROWS_OK")
    assert reps[0]["tables"] == reps[1]["tables"] == {
        "i32": [19 * 4, [37]], "u8": [19, [37]], "pair": [21 * 8, [41, 2]]}


def _long_cfg(art, prefix, **kw):
    return dict(mode="map", fa=art["fa"], fq=art["fq_long"], prefix=prefix,
                chunk_b=CHUNK_B, force_gact=LONG_L, **kw)


def _jax_long(art, monkeypatch):
    monkeypatch.setenv("LRM_MID_DIRS_BUDGET", "0")
    return _jax_run(art, "long", art["fq_long"])


def test_long_reads_gact_two_ranks_equal_jax(art, tmp_path, monkeypatch):
    """(f) Six 2.6 kb reads, the 3072 bucket forced through gact (a zero
    resident budget, JAX's LRM_MID_DIRS_BUDGET=0), at two ranks: the mesh
    mode's full-band gact pass equals JAX's mesh run."""
    want, want_vt = _jax_long(art, monkeypatch)
    assert want_vt[1] == 6 and want_vt[0] >= 5
    prefix = str(tmp_path / "long.sam")
    reps = _reports(_launch(2, _long_cfg(art, prefix), tmp_path))
    assert [(r["valid"], r["total"]) for r in reps] == [want_vt] * 2
    # the 3072 bucket's global batch: max(8, 16 * 1024 // 3072 // 8 * 8)
    assert _merge(prefix, 2, 8) == want
    assert all(r["sat"] == 0 and r["retried"] == 0 for r in reps)


def _single_device_sam(art, fq) -> str:
    """The port's direct single-device mapping of `fq`, the gact path
    forced on the 3072 bucket."""
    from dataclasses import replace
    from longreadmapper_tpu_torch.formats.sam import sam_header
    from longreadmapper_tpu_torch.index.device import load_device_index
    from longreadmapper_tpu_torch.models.mapper import TorchMapper
    from longreadmapper_tpu_torch.runtime.reads import load_read_batches
    idx, meta, mta = load_device_index(art["fa"], "cpu", verbose=False)
    tm = TorchMapper(idx, meta, mta, art["params"], chunk_b=CHUNK_B,
                     device="cpu")
    tm._cfgs[LONG_L] = replace(tm._step_for(LONG_L), mid_dirs_budget=0)
    text = [sam_header(mta, 0)]
    for batch in load_read_batches(fq, 64, background=False):
        text += [t for t, _, _ in tm.map_stream_sam(iter([batch]))]
    return "".join(text)


@pytest.mark.parametrize("shard", [False, True],
                         ids=["replicated_data2", "sharded_model2"])
def test_mesh_saturation_tier_two_ranks(art, tmp_path, monkeypatch, shard):
    """The mesh's gact saturation tier (the port departs from JAX, whose
    mesh mode leaves bit 1 unrecovered): bit 1 forced on every submitted
    part at two ranks.  Replicated (data 2), each rank re-runs its own
    rows; sharded (model 2), both ranks of the group hold the same rows
    and flag, and re-run them together.  The SAM equals the port's
    single-device direct mapping, and JAX's mesh run without the flag."""
    want, want_vt = _jax_long(art, monkeypatch)
    direct = _single_device_sam(art, art["fq_long"])
    assert direct == want
    prefix = str(tmp_path / "sat.sam")
    kw = dict(shard=True, model_shards=2) if shard else {}
    reps = _reports(_launch(2, _long_cfg(art, prefix, force_sat=True, **kw),
                            tmp_path))
    assert [(r["valid"], r["total"]) for r in reps] == [want_vt] * 2
    assert all(r["sat"] == 1 for r in reps)
    assert _merge(prefix, 1 if shard else 2, 8) == direct


def test_hung_rank_fails_within_group_timeout(tmp_path):
    """A rank that never joins a collective fails its peer within the
    group's timeout (seconds), not Gloo's 30-minute default."""
    outs = _launch(2, dict(mode="hang", timeout_s=3, sleep_s=12), tmp_path,
                   timeout=60)
    rc, out, err = outs[0]
    assert rc == 3, (rc, out, err[-2000:])
    took = float(out.split("HANG_FAILED after ", 1)[1].split(" s")[0])
    assert took < 20, out


def test_failed_group_setup_raises(monkeypatch):
    """A world of 2 whose second rank never comes: init_distributed raises
    within its timeout, and no group is left behind."""
    import torch.distributed as dist
    from longreadmapper_tpu_torch.runtime.launch import init_distributed
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        init_distributed("cpu", timeout_s=2)
    assert time.perf_counter() - t0 < 30
    assert not dist.is_initialized()


def test_mapdist_cuda_without_card_raises(art, tmp_path):
    """`mapdist --device cuda` where torch sees no card raises before any
    process group forms."""
    import torch.distributed as dist
    from longreadmapper_tpu_torch import cli
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["mapdist", art["fa"], art["fq"], "--out-prefix",
                  str(tmp_path / "x.sam"), "--device", "cuda", "--quiet"])
    assert not dist.is_initialized()
